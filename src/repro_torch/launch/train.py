"""End-to-end training driver (port of ``repro/launch/train.py``).

Wires config -> model -> state -> data pipeline -> fault-tolerant
runner.  It trains a reduced config (``reduce_config``) for real, on the
card by default; the full config is ``--reduce 1``.

Under a process group of more than one rank, ``train`` runs data
parallel over ``make_host_mesh(model_axis)``, as the reference runs
under its mesh: the params and the AdamW moments are DTensors placed by
``sharding_for_meta`` (replicated at model axis 1; at model axis 2 the
dims the rule table maps to ``model`` shard, and the moments also take
the ZeRO-1 rule over ``data``), the pipeline places each batch on
``data``, and the step runs under ``use_mesh``, so DTensor reduces the
gradients (through the host on the card: ``GlooCollectives``).  Every
rank draws the whole state from the same seed and keeps its shards.
Checkpoints gather each DTensor leaf, each rank into ``rank<r>`` under
the checkpoint directory, and the runner's restore places each leaf as
the one it replaces.  ``--ranks N`` starts N ranks on this host
(``distributed.launch.spawn``): the port's form of the reference's
"every local device".

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduce 8 --steps 200 --batch 8 --seq 256 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduce 16 --steps 16 --batch 4 --seq 64 --ranks 2 --model-axis 2 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, synthetic_lm_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (ShardingRules, named_sharding,
                                              place, sharding_for_meta,
                                              use_mesh)
from repro_torch.distributed.spmd import (ReplicateUnplaceable,
                                          replicated_ops)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.runtime import (
    FaultTolerantRunner,
    RunnerConfig,
    TrainSettings,
    init_train_state,
    make_train_step,
    train_state_meta,
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
          fault_hook: Optional[Callable[[int], None]] = None,
          dtype: Optional[str] = None,
          profile_step: Optional[int] = None) -> Dict[str, Any]:
    """Train ``reduce_config(arch, reduce)`` for ``steps`` steps of
    ``batch`` x ``seq`` synthetic tokens on ``device`` (``None``: CUDA),
    params from ``torch.Generator`` seeded ``seed``, checkpoints every
    ``ckpt_every`` steps in ``ckpt_dir`` (default: ``repro_torch_ckpt_
    <arch>`` in the temporary directory; a run resumes from the latest
    checkpoint there).  ``fault_hook(step)`` runs before each step
    attempt (a test injects failures with it).  ``dtype`` overrides the
    config's compute dtype (``"float32"``: a data-parallel run then
    agrees with one rank's to f32 rounding, where bf16 activations
    summed in another order differ by bf16 rounding, which AdamW
    amplifies on gradients near zero).  ``profile_step`` runs that
    step under the op profiler and records the collective bytes it moved
    by kind (``step_collective_bytes``).  Returns the runner's
    result with every loss, the first and last, the wall, the param
    count, the final state and the ops run replicated
    (``spmd.replicated_ops``, process-wide)."""
    dev = resolve_device(device)
    cfg = reduce_config(get_config(arch), reduce)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    mesh = make_host_mesh(model_axis, device=dev)
    if mesh is not None and mesh.size() == 1:
        mesh = None  # one rank shards nothing
    model = build_model(cfg)
    schedule = warmup_cosine(max(steps // 20, 10), steps)
    settings = TrainSettings(optimizer=AdamWConfig(lr=lr, schedule=schedule))
    rules = ShardingRules().with_overrides(dict(cfg.sharding_overrides))

    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(use_mesh(mesh, rules))
            stack.enter_context(ReplicateUnplaceable())
        state = init_train_state(
            torch.Generator(device=dev).manual_seed(seed), model, settings,
            device=dev)
        batch_sh = None
        if mesh is not None:
            state = tree_map(lambda x, sh: place(x, *sh), state,
                             state_shardings(model, settings, mesh))
            batch_sh = {k: named_sharding((batch, seq), ("batch", None),
                                          mesh)
                        for k in ("labels", "tokens")}
        return _run(arch, model, settings, state, cfg, steps=steps,
                    batch=batch, seq=seq, seed=seed, dev=dev,
                    batch_sh=batch_sh, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every, log_every=log_every,
                    fault_hook=fault_hook, profile_step=profile_step)


def state_shardings(model, settings: TrainSettings, mesh) -> Dict[str, Any]:
    """The train state's :class:`~repro_torch.distributed.sharding.
    Sharding` tree: params by ``sharding_for_meta``, the moments with the
    ZeRO-1 rule, as the reference's dry run places them."""
    smeta = train_state_meta(model, settings)
    return {"params": sharding_for_meta(smeta["params"], mesh),
            "opt": {"m": sharding_for_meta(smeta["opt"]["m"], mesh,
                                           extra_zero=True),
                    "v": sharding_for_meta(smeta["opt"]["v"], mesh,
                                           extra_zero=True),
                    "step": sharding_for_meta(smeta["opt"]["step"], mesh)}}


def _run(arch, model, settings, state, cfg, *, steps, batch, seq, seed,
         dev, batch_sh, ckpt_dir, ckpt_every, log_every, fault_hook,
         profile_step):
    step_fn = make_train_step(model, settings)
    collectives: Dict[str, float] = {}
    if profile_step is not None:
        step_fn = _profiled_call(step_fn, profile_step, collectives)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = DataPipeline(
        lambda sd, st: synthetic_lm_batch(sd, st, batch, seq,
                                          cfg.vocab_size),
        shardings=batch_sh, seed=seed, device=dev)
    try:
        ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                            f"repro_torch_ckpt_{arch}")
        if batch_sh is not None:  # each rank writes (and reads) its own
            ckpt_dir = os.path.join(ckpt_dir, f"rank{dist.get_rank()}")
        ckpt = CheckpointManager(ckpt_dir, keep=3)
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
        "losses": losses,
        "step_s": [m["step_time_s"] for m in runner.metrics_log],
        "state": runner.state,
        "step_collective_bytes": collectives,
        # the ops DTensor could not place, run on whole operands
        "replicated_ops": replicated_ops(),
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }
    if log_every:
        for m in runner.metrics_log[::log_every]:
            print(f"step {m['step']:5d} loss={m.get('loss', float('nan')):.4f} "
                  f"dt={m['step_time_s']:.3f}s"
                  + (" STRAGGLER" if m.get("straggler") else ""))
    return result


def _profiled_call(step_fn, index: int, collectives: Dict[str, float]):
    """``step_fn`` whose ``index``-th call (from 0) runs under the op
    profiler, its collective bytes by kind put in ``collectives``."""
    from repro_torch.core.signature import _Profiler

    calls = [0]

    def step(state, batch):
        calls[0] += 1
        if calls[0] != index + 1:
            return step_fn(state, batch)
        # the profiler, then DTensor's fallback innermost (as under train)
        with _Profiler() as prof, ReplicateUnplaceable():
            out = step_fn(state, batch)
        collectives.update(prof.stats.collective_bytes)
        return out

    return step


def rank_train(arch: str, kw: Dict[str, Any],
               params: bool = False) -> Dict[str, Any]:
    """One rank of a group running ``train(arch, **kw)``: its result
    without the state (rank 0 logs); with ``params``, rank 0's result
    also holds every param gathered whole, as numpy (``params_whole``, in
    ``tree_leaves`` order; every rank takes part in the gathers)."""
    from repro_torch.distributed.sharding import whole

    kw = dict(kw)
    log = kw.pop("log_every", 10)
    out = train(arch, log_every=log if dist.get_rank() == 0 else 0, **kw)
    state = out.pop("state")
    if params:
        leaves = [whole(x).cpu().numpy()
                  for x in tree_leaves(state["params"])]
        if dist.get_rank() == 0:
            out["params_whole"] = leaves
    return out


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
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (the config's by default)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks to start on this host (gloo; they share "
                         "the card on CUDA)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds the ranks may take (--ranks > 1)")
    args = ap.parse_args(argv)
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              reduce=args.reduce, lr=args.lr, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, model_axis=args.model_axis,
              device=args.device, dtype=args.dtype)
    if args.ranks > 1:
        from repro_torch.distributed.launch import spawn

        out = spawn(rank_train, args.ranks, args.arch, kw,
                    device_type=resolve_device(args.device).type,
                    timeout_s=args.timeout)[0]
    else:
        out = train(args.arch, **kw)
    print(f"[train] {args.arch}: params={out['params']/1e6:.1f}M "
          f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f} "
          f"in {out['wall_s']:.0f}s ({out['final_step']} steps, "
          f"{out['recoveries']} recoveries)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
