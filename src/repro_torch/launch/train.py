"""End-to-end training driver (port of ``repro/launch/train.py``).

Wires config -> model -> state -> data pipeline -> fault-tolerant
runner.  It trains a reduced config (``reduce_config``) for real, on the
card by default; the full config is ``--reduce 1``.

Data-parallel training over more than one rank is not ported yet
(ROADMAP queue 1 item 5c): under a mesh of more than one rank, ``train``
raises ``NotImplementedError``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduce 8 --steps 200 --batch 8 --seq 256 --ckpt-dir DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, synthetic_lm_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.runtime import (
    FaultTolerantRunner,
    RunnerConfig,
    TrainSettings,
    init_train_state,
    make_train_step,
)


def reduce_config(cfg, factor: int):
    """Shrink a full config by ~factor x in width/depth for host runs."""
    if factor <= 1:
        return cfg
    d_model = max(cfg.d_model // factor, 64)
    return cfg.replace(
        num_layers=max(cfg.num_layers // factor, 2),
        d_model=d_model,
        num_heads=max(cfg.num_heads // factor, 2),
        num_kv_heads=max(cfg.num_kv_heads // factor, 1),
        head_dim=max(cfg.resolved_head_dim() // max(factor // 2, 1), 16),
        d_ff=max(cfg.d_ff // factor, 128),
        vocab_size=max(cfg.vocab_size // factor, 2048),
        moe=None if cfg.moe is None else dataclasses.replace(
            cfg.moe, num_experts=max(cfg.moe.num_experts // factor, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff=max(cfg.moe.d_ff // factor, 64),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            dense_d_ff=max((cfg.moe.dense_d_ff or cfg.d_ff) // factor, 128),
            group_size=1024),
        mla=None if cfg.mla is None else dataclasses.replace(
            cfg.mla, kv_lora_rank=max(cfg.mla.kv_lora_rank // factor, 32),
            q_lora_rank=0,
            rope_head_dim=max(cfg.mla.rope_head_dim // factor, 8),
            nope_head_dim=max(cfg.mla.nope_head_dim // factor, 16),
            v_head_dim=max(cfg.mla.v_head_dim // factor, 16)),
        ssm=None if cfg.ssm is None else dataclasses.replace(
            cfg.ssm, state_dim=max(cfg.ssm.state_dim // factor, 16),
            head_dim=max(cfg.ssm.head_dim // max(factor // 2, 1), 16),
            chunk_size=64),
        rglru=None if cfg.rglru is None else dataclasses.replace(
            cfg.rglru, lru_width=max((cfg.rglru.lru_width or d_model)
                                     // factor, 64), block_width=64),
        sliding_window=(min(cfg.sliding_window, 128)
                        if cfg.sliding_window else None),
        grad_accum=1,
    )


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 256,
          reduce: int = 8, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, model_axis: int = 1, seed: int = 0,
          log_every: int = 10, device: DeviceLike = None,
          fault_hook: Optional[Callable[[int], None]] = None
          ) -> Dict[str, Any]:
    """Train ``reduce_config(arch, reduce)`` for ``steps`` steps of
    ``batch`` x ``seq`` synthetic tokens on ``device`` (``None``: CUDA),
    params from ``torch.Generator`` seeded ``seed``, checkpoints every
    ``ckpt_every`` steps in ``ckpt_dir`` (default: ``repro_torch_ckpt_
    <arch>`` in the temporary directory; a run resumes from the latest
    checkpoint there).  ``fault_hook(step)`` runs before each step
    attempt (a test injects failures with it).  Returns the runner's
    result with the first and last loss, the wall and the param count."""
    dev = resolve_device(device)
    cfg = reduce_config(get_config(arch), reduce)
    mesh = make_host_mesh(model_axis, device=dev)
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            f"data-parallel training over {mesh.size()} ranks is not ported "
            f"yet (ROADMAP queue 1 item 5c)")
    model = build_model(cfg)
    schedule = warmup_cosine(max(steps // 20, 10), steps)
    settings = TrainSettings(optimizer=AdamWConfig(lr=lr, schedule=schedule))

    state = init_train_state(torch.Generator(device=dev).manual_seed(seed),
                             model, settings, device=dev)
    step_fn = make_train_step(model, settings)
    pipe = DataPipeline(
        lambda sd, st: synthetic_lm_batch(sd, st, batch, seq,
                                          cfg.vocab_size),
        seed=seed, device=dev)
    try:
        ckpt = CheckpointManager(
            ckpt_dir or os.path.join(tempfile.gettempdir(),
                                     f"repro_torch_ckpt_{arch}"), keep=3)
        runner = FaultTolerantRunner(
            step_fn, state, ckpt,
            RunnerConfig(total_steps=steps, checkpoint_every=ckpt_every),
            fault_hook=fault_hook)
        del state  # the runner holds it (and drops it on its first step)

        batches: Dict[int, Any] = {}

        def get_batch(step: int):
            while step not in batches:
                s, b = next(pipe)
                batches[s] = b
                for k in list(batches):
                    if k < step:
                        del batches[k]
            return batches.pop(step)

        t0 = time.time()
        out = runner.run(get_batch)
    finally:
        pipe.close()

    losses = [m["loss"] for m in runner.metrics_log if "loss" in m]
    result = {
        **out,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": time.time() - t0,
        "params": int(sum(x.numel() for x in tree_leaves(
            runner.state["params"]))),
        "metrics_log": runner.metrics_log[-5:],
    }
    if log_every:
        for m in runner.metrics_log[::log_every]:
            print(f"step {m['step']:5d} loss={m.get('loss', float('nan')):.4f} "
                  f"dt={m['step_time_s']:.3f}s"
                  + (" STRAGGLER" if m.get("straggler") else ""))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                reduce=args.reduce, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, model_axis=args.model_axis,
                device=args.device)
    print(f"[train] {args.arch}: params={out['params']/1e6:.1f}M "
          f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f} "
          f"in {out['wall_s']:.0f}s ({out['final_step']} steps, "
          f"{out['recoveries']} recoveries)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
