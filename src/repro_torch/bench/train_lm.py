"""End-to-end training driver (port of ``examples/train_lm.py``): train a
reduced qwen3-family model for a few hundred steps on the card, with
checkpoint/restart and the fault-tolerant runner; the loss must go
down.

  PYTHONPATH=src python -m repro_torch.bench.train_lm [--steps 200]

The reference's defaults: qwen3-4b at ``--reduce 6``, batches of 8 x 256
tokens, lr 1e-3, a checkpoint every 100 steps, 200 steps, and the same
assertion (the last loss below the first).  Checkpoints go to a fresh
temporary directory, removed at the end, unless ``--ckpt-dir`` names one
(the reference's default directory would resume an earlier run).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import train


def run(argv=None) -> dict:
    """Parse ``argv``, train and print the summary line; returns
    ``launch.train.train``'s result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduce", type=int, default=6)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
        out = train(args.arch, steps=args.steps, batch=8, seq=256,
                    reduce=args.reduce, lr=1e-3, ckpt_every=100,
                    ckpt_dir=args.ckpt_dir or tmp, device=args.device)
    print(f"\n[train_lm] {args.arch}/reduce{args.reduce}: "
          f"{out['params']/1e6:.1f}M params, "
          f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f}, "
          f"{out['wall_s']:.0f}s, recoveries={out['recoveries']}")
    return out


def main(argv=None) -> int:
    out = run(argv)
    if not out["last_loss"] < out["first_loss"]:
        raise SystemExit("loss did not improve")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
