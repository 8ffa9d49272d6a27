#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: the card's name and power limit, torch/CUDA versions,
   which torch ops take uint32 on the card, and the kernels' build
   (``nvcc`` on ``src/repro_torch/kernels/csrc``) with its time and
   ptxas's registers and spills; a spill in ``bitonic_sort.cu`` or
   ``rmsnorm.cu`` fails the run;
2. kernels: each of the six hand-written kernels against its plain
   PyTorch version on the card, at ragged shapes and at full-width shapes
   of models the repo supports (qwen3-4b, tinyllama-1.1b,
   deepseek-v2-lite-16b), with kernel, plain and one-library-call times
   (CUDA events over back-to-back calls), the kernel's device time and
   device kernels a call (one ``torch.profiler`` run over the same
   iterations: a time well under ``ms`` is the host's) and its bound;
   each matmul, row moments, rmsnorm, flash attention and MoE dispatch
   case logs the form it took (matmul: narrow up to 32 columns, wide
   above; row moments: one launch or split; rmsnorm: warp on 16-byte
   units, scalar off the 16-byte grid or for longer rows; wgmma for bf16
   flash attention at head width 64 or 128 and for bf16-x MoE dispatch,
   simt otherwise), each bitonic sort case its passes, and each row
   moments and rmsnorm case is held bit-equal across two calls; each
   rmsnorm case also times ``copy_`` of its input (events and device ms),
   the card's read-and-write ceiling for the same bytes;
3. main path: ``generate_proxy`` on K-means at ``SCALE`` (1.0: 400,000
   x 64 f32 points, 32 centroids) with ``substrate="hopper"``, with every
   kernel's launch counter zeroed just before and read just after; a
   kernel of that path (matmul, row moments, bitonic sort) the path never
   launched fails the run, and so does a K-means step or tuned proxy
   whose wall time was not taken as a captured CUDA graph's replays
   (every ``generate_proxy`` report below logs how its two walls were
   taken: ``graph``, or ``eager`` and why);
4. checks: the K-means step's outputs, and the tuned proxy's outputs on
   the kernels against its stock-PyTorch form on the same inputs;
5. main-path shapes: each of the path's kernels once more on the inputs
   the tuned proxy gives it, against its plain version, timed, with its
   bound; a row moments call in its one-launch form that runs more than
   one device kernel fails the run;
6. traces: one ``torch.profiler`` run each of the K-means step and the
   tuned proxy — wall time eager (median of 5 dispatches) and as the
   port times it (median of 5 captured-graph replays, or eager where the
   capture fails, with the reason), device busy share of each, top device
   kernels — and the step-over-proxy speedup both ways;
6b. workloads: phases 3 to 6 for each of TeraSort (2M records), PageRank
   (262,144 vertices, 4,194,304 zipf edges), AlexNet (batch 128, 32x32x3)
   and Inception-V3 (batch 32, 75x75x3) at ``SCALE``: ``generate_proxy``
   with ``substrate="hopper"`` and ``MAX_ITERS``, counters zeroed
   just before and read just after (TeraSort must launch the bitonic sort,
   AlexNet and Inception-V3 matmul and row moments; the lowering declines
   all of PageRank's hinted variants); the step on the card against the
   same step on CPU copies of its inputs (TeraSort exact, PageRank
   ``PAGERANK_TOL``, the AI steps ``AI_STEP_TOL`` with TF32 allowed around
   the card's call); the tuned proxy against its stock form; the path's
   kernels at the proxy's shapes; traces of the step and the proxy;
6c. paper_repro: the port's paper-reproduction sweep
   (``repro_torch.bench.paper_repro.run_one``) over all five workloads,
   each from the reference benchmark's ``BASE_P`` at ``PAPER_SCALE`` (0.5)
   and ``PAPER_ITERS`` (40), through one ``EvalSession`` with
   ``substrate="hopper"`` and a ``ProxyStore`` in a temporary directory,
   counters zeroed just before; each report logged as in phase 3; fails
   if a kernel of a workload's path never launched, the per-workload
   compiles do not sum to the session's, or the JSON document lacks a
   key of the reference benchmark's; then a fresh session on the same store
   replays every tuned proxy, which must take 0 compiles, one store hit
   a distinct key, and give the sweep's metrics bit for bit;
6e. case_studies: the port's §IV case studies
   (``repro_torch.bench.case_studies``, one ``--case`` a call) at the
   reference's defaults (``--iters 16``, case A's K-means at scale 0.3,
   case B's TeraSort and PageRank at 0.3 then 0.6, case C's five
   workloads at 0.2), uncut, with ``--substrate hopper``, counters zeroed
   just before and read after each case; each case's accuracies, case
   C's ratios and orders and each timed run's timing mode logged.  Fails
   if case A never launched matmul, row moments or the bitonic sort, case
   B (whose TeraSort alone reaches a kernel) never launched the sort, or
   a document lacks a key of the reference's;
6f. population (needs main): the population form.  (a) each main-path
   op's vmapped form (``torch.func.vmap`` through its batching rule) at
   2 and 32 lanes built from the inputs phase 3's tuned proxy gives it
   (lane 0 the input, every other lane a seeded permutation of its
   elements, so neighbouring lanes must differ by more than the
   tolerance; matmul with lanes on both operands, the kernel's lane
   axis, and on x alone, folded into M), one launch a call, against a
   per-lane loop of its plain version (sort exact, else
   ``rtol=atol=1e-3``), timed beside
   the loop and one library call (``torch.bmm``, ``torch.var_mean``,
   ``torch.sort`` of the int32 image); (b) ``population_runtime`` on a
   ``run=True`` engine over the tuned proxy's impact batch
   (``tuner_bench.impact_batch``): every class must vmap, every lane
   equal its candidate's eval form on the card, and each kernel launch
   as often a chunk as one lane launches it; its wall is logged beside
   the batched engine's per-class walls; (c) ``tuner_bench``: single
   and sweep with ``--run --substrate hopper`` (the sweep with
   ``--workers 1`` and auto); any gate fails the run.  Its priors mode
   is not run (``TUNER_BENCH_RUNS``);
6d. serve (needs paper_repro): the proxy server, counters zeroed just
   before and read after the last server's shutdown.  First the port's
   ``serve_bench --check`` at the reference's defaults (8 shape classes,
   4 clients x 12 requests, 1 tune, open loop at 4 and 16 req/s) with
   ``--substrate hopper``, a store (its warm-start probe a child process
   on the card that must profile nothing) and a trace that
   ``trace_summary --check`` must pass; then a ``ProxyServer`` over a
   hopper ``EvalSession`` on phase 6c's store: a tune of K-means at
   phase 3's size, then 4 closed-loop clients x 12 requests over the
   sweep's five proxies and the one just tuned.  Fails if an evaluate
   differs by a bit from a serial session's, a sweep proxy was profiled
   rather than read from the store, the server counted an error, or
   matmul, row moments or bitonic sort never launched;
6g. scenarios: the cluster scenarios (``repro_torch.bench.scenario_matrix``
   with ``--substrate hopper`` at the reference's defaults, scale 0.2,
   8 iterations, scenarios single, dp2, dp4 and dp2_mp2), each run a
   child process of ``SCENARIO_RANKS`` (4) ranks that share the card,
   gloo between them, so every rank's launch counters start at 0
   (``SCENARIO_RUNS``: K-means and PageRank re-tuned under each mesh
   with the population bench and ``--check``, TeraSort with
   ``--check``, AlexNet and Inception-V3 without it, their steps not
   splitting on every mesh at that scale).  Logs each cell's collective
   bytes by kind for the step and the proxy and how each wall was
   taken, and each rank's launches and device-memory peak.  Fails if a
   run fails its checks, a multi-device proxy moves no collective, a
   step moves collective bytes exactly when its inputs do not split,
   ``single`` differs from the serial engine by a bit, the hopper proxy
   differs from the stock form on dp2, or a rank never launched a
   kernel its workloads' proxies lower onto;
6h. stress: the stress tier, after the scenarios.  (a)
   ``repro_torch.bench.stress_matrix --check --substrate hopper`` at
   full size (the 1<<22-key scale case) in a child process of
   ``STRESS_RANKS`` (4) ranks sharing the card: every gate must pass and
   every case on every rank end as the reference's does (``typed_failure``
   for ``STRESS_TYPED``, ``completed`` for the other seven), the skew
   sweep with one profile, the fault case with one recovery, the device
   drop typed at one device and replayed on a (1, 2) mesh, and every
   rank must launch the bitonic sort; (b) and (c) in a group of four
   ranks of its own, each running ``repro_torch.bench.stress_group``
   (the rank body the CPU tests run in two ranks): the GPipe
   ``pipeline_apply`` over the four ranks at the reference test's shape
   (4 stages, 8 microbatches of (2, 16), ``tanh(h @ w)``, and its tree
   form) against ``gpipe_reference`` on one rank (max abs err within
   ``PIPE_TOL``), a state (f32 (4096, 256), int64 counter, bf16 (1024,))
   sharded on dp4, saved with ``blocking=False`` and restored onto dp2,
   as its prototypes are placed, and onto one rank, each exactly, and a
   ``FaultTolerantRunner`` on a dp4-sharded state through one injected
   fault.  Logs each case's payload and each rank's launches and
   device-memory peaks;
6i. model: the model zoo's serving path (``repro_torch.models``,
   ``repro_torch.runtime.serve_loop``), counters zeroed just before and
   read just after.  (a) qwen3-4b at full width and depth (36 layers,
   about 4.02 B f32 params from a seed, bf16 activations) on the card: a
   prefill of 4 x 1024 tokens, ``pad_caches`` to 1056, 32 greedy decode
   steps, then a teacher-forced ``forward`` over the same 1056 tokens;
   fails on a non-finite logit or a step outside ``MODEL_BF16_*`` of the
   forward at its position, and logs prefill tokens/s, decode ms a token
   (median of the steps after the first) beside the bounds, the device
   busy time and top kernels of a profiled prefill and step, the
   device-memory peak, and for each row whose greedy token differs from
   the forward's argmax the forward's top-1 minus top-2 logit beside the
   position's error; (b) the same width at two layers in f32 with TF32
   off, a prefill of 128 tokens and 4 decode steps on the card against
   the port on the host on the same weights and tokens
   (``MODEL_F32_TOL``).  (a') deepseek-v2-lite-16b (multi-head latent
   attention, 26 MoE layers of 64 experts, top 6) at full width and
   depth, 15.7 B f32 params (62.8 GB): as (a) with a prompt of 4 x 992,
   ``pad_caches`` to 1024 and 32 steps, timed at its shipped capacity
   factor; the oracle serves the same weights again at a capacity where
   no group of the run drops, and its forward over 4 x 1024 tokens (one
   MoE group) holds it at ``MOE_BF16_ATOL_STD``; logs where its routing
   differs from the forward's, and the assignments the shipped
   capacity's forward over the same tokens drops and its gap to the
   no-drop one (neither held); (a'') the same oracle in f32 on one row
   of the prompt (``F32_ORACLE_TOL``); (b') as (b) at its width (one dense,
   one MoE layer).  (c) mamba2-780m (48 SSD layers, 0.78 B f32 params),
   a prompt of 4 x 1000 (off the chunk of 256, so the padded chunk
   runs); (d) recurrentgemma-9b (12 (RG-LRU, RG-LRU, local) superblocks
   and an (RG-LRU, RG-LRU) tail, 9.40 B f32 params = 37.6 GB), a prompt
   of 2 x 2304 (the local layers' caches rings of 2048, decode
   wrapping); (e) whisper-small (12 + 12 layers, 0.34 B params), 4 x
   1500 encoder frames and a prompt of 4 x 32 tokens; each with 32
   greedy steps as (a), held to its forward (mamba2-780m at 2.0 x the
   std, measured: ``FAMILY_RUNS``), its f32 oracle as (a'') (mamba2-780m
   at atol 6e-3, measured) and its host check as (b) (recurrentgemma-9b's
   at three layers, one superblock).  Fails if any of the six kernels launched: the zoo keeps
   its own attention, norms, MoE dispatch and scans, as the reference's
   does;
6j. train: the model zoo's training path (``repro_torch.optim``,
   ``data.pipeline``, ``runtime.train_loop``, ``Model.loss`` with remat
   and the flash backward), counters zeroed just before and read just
   after.  (a) tinyllama-1.1b at full width and depth (22 layers,
   1,100,048,384 f32 params from a seed, bf16 activations, remat, AdamW
   under ``warmup_cosine``): one warm-up step and ``TRAIN_STEPS`` (6)
   timed steps of 8 x 2048 tokens from ``synthetic_lm_batch`` through
   ``DataPipeline`` and ``make_train_step``, then one step under the
   profiler; fails on a non-finite loss or grad norm, a step-0 loss more
   than ``TRAIN_LOSS_BAND`` from ln(vocab) or a param leaf the step left
   unchanged, and logs step ms (median), tokens/s, device busy ms and
   launches and the memory peak beside ``train_bounds`` and every
   step's loss; (b) the same width at two layers in f32 with TF32 off,
   one step of 2 x 256 on the card against the host from the same state
   (``TRAIN_HOST_TOL`` over the loss, the grad norm and every leaf of
   params, m and v); (c) the flash backward at (1, 2048, 32, 64) over 4
   KV heads, causal and windowed with softcap, against autograd through
   the plain forward (``FLASH_BWD_TOL`` of each gradient's largest
   entry); (d) ``repro_torch.bench.train_lm`` at its defaults through
   ``launch.train``, ``FaultTolerantRunner`` and ``CheckpointManager``:
   the last loss below the first, 0 recoveries.  Fails if any of the six
   kernels launched;
6k. pod: the dry run and data-parallel training (``repro_torch.launch.
   dryrun``, ``launch.train`` over ranks).  (a) ``launch.train.train``
   at ``bench/train_lm``'s configuration (qwen3-4b reduced 6 x,
   24,511,266 params, 8 x 256 tokens) for 20 steps in f32 over 4 gloo
   ranks sharing the card, at meshes (4, 1) and (2, 2), the two groups
   at once: each rank's losses and rank 0's gathered final params
   within ``POD_TOL`` of one rank's run of the same steps on the card;
   logs the step ms, the collective bytes of a profiled step and each
   rank's memory peak.  (b), as subprocesses beside (c): one rank of a
   fake world of 256 (512) ranks on meta tensors, no card and no
   memory: qwen3-4b's ``train_4k``, ``prefill_32k`` and ``decode_32k``
   and deepseek-v2-lite-16b's ``train_4k`` on (16, 16), and qwen3-4b's
   ``train_4k`` on (2, 16, 16): each record's flops and bytes a device,
   collective bytes by kind, peak, ``fits_hbm``, dominant term and useful
   flops fraction, and its walls; an error or a missing cell fails.  (c)
   ``bench/proxy_for_pod_model --arch qwen3-4b --substrate hopper
   --iters 12`` with every counter zeroed just before and read just
   after: fails if ``matmul`` never launched.  (d) the roofline section
   of ``bench/run`` over (b)'s records;
7. bench: the kernel entry point's path, with every launch counter
   zeroed just before and read just after: ``repro_torch.bench.
   kernels_bench --check`` in-process on the card, then ``ops.rmsnorm``,
   ``ops.flash_attention`` and ``ops.moe_dispatch`` at the full-width
   shapes of phase 2; a kernel of the six never launched, or the
   tensor-core form of flash attention or of MoE dispatch never launched,
   fails the run.

Each phase logs its seconds and the card's memory after it: allocated,
reserved by the caching allocator, and free.

The last lines are the kernel table as JSON (all six kernels: the first
three with their launches over phase 3 and their phase-5 times, the other
three with their launches over phase 7 and their full-width phase-2
times, each with its device ms, and each with its launches over every
workload of phase 6b and its times at those workloads' shapes, its
launches over each workload of phase 6c, its launches over phase 6d
as ``serve_launches``, its launches over each case of phase 6e as
``case_studies_launches``, for the first three its launches on each
rank of each run of phase 6g as ``scenario_launches``, its launches on
each rank of phase 6h (a) as ``stress_launches``, its launches over
phase 6i as ``model_launches``, its launches over phase 6j as
``train_launches``, its launches over phase 6k (c) as ``pod_launches``,
and, for the first three, its launches over
one call a chunk of phase 6f (b) as ``population_launches`` and its
phase 6f (a) rows as ``lane_forms``), the
card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU path: the script
exits non-zero without a CUDA device, and outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

#: H100 SXM peaks at the full 700 W limit (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# tolerances against the plain versions on the card:
#  matmul f32 — the same f32 products summed in another order;
#  matmul bf16 — one bf16 rounding of an f32 result may flip by an ulp;
#  row_moments — f32 sums reassociated across threads and splits (bf16
#  inputs are summed in f32 by both versions, so the same);
#  sort — exact (a sort's output is unique);
#  rmsnorm f32 — rsqrtf's 2 ulp and a reassociated sum of squares;
#  rmsnorm bf16 — the final bf16 rounding may flip by an ulp;
#  flash_attention f32 — the reference's own (tests/test_kernels.py):
#  online softmax against a dense one;
#  flash_attention bf16 — held element by element: rtol for the output's
#  bf16 rounding in both versions (2 x 2^-8, with room), and, since the
#  kernel rounds p to bf16 before the PV product (2^-8 relative each)
#  where the plain version stays f32, P_ROUNDING times that element's
#  attention over |v| (sum_k p|v| / l, the most that rounding can move
#  it, taken twice); a fixed atol would be as large as the outputs
#  themselves at 4096 keys (std ~ sqrt(e/n));
#  moe_dispatch — exact for one-hot masks (one product with 1.0 plus
#  zeros); a dense mask's f32 sums reassociated, and in bf16 one rounding
#  of the f32 result.
TOL = {
    ("matmul", "float32"): dict(rtol=1e-4, atol=1e-4),
    ("matmul", "bfloat16"): dict(rtol=1e-2, atol=1e-2),
    ("row_moments", "float32"): dict(rtol=1e-4, atol=1e-5),
    ("row_moments", "bfloat16"): dict(rtol=1e-4, atol=1e-5),
    ("rmsnorm", "float32"): dict(rtol=1e-5, atol=1e-5),
    ("rmsnorm", "bfloat16"): dict(rtol=1e-2, atol=1e-2),
    ("flash_attention", "float32"): dict(rtol=2e-3, atol=2e-4),
    ("flash_attention", "bfloat16"): dict(rtol=1e-2, atol=1e-5),
    ("moe_dispatch", "float32"): dict(rtol=1e-4, atol=1e-4),
    ("moe_dispatch", "bfloat16"): dict(rtol=1e-2, atol=1e-2),
}
#: bf16 flash attention's allowance per unit of attention over |v|
P_ROUNDING = 2.0 ** -7

#: small MoE dispatch shapes (T, E, C, D): aligned one-tile, C and D
#: ragged inside 16-byte rows across two tiles each, a T that is not a
#: multiple of the 64-token slab, and C, D that rule out vector loads
MOE_SMALL = ((64, 8, 16, 32), (128, 4, 64, 16), (200, 3, 136, 264),
             (300, 5, 70, 130), (37, 3, 5, 24))

#: sources whose every kernel must compile without spilling
NO_SPILL = ("bitonic_sort.cu", "rmsnorm.cu")

#: the kernels ``generate_proxy`` on K-means reaches (``kernel_lowerings``)
MAIN_PATH_KERNELS = ("matmul", "row_moments", "bitonic_sort")

#: the kernels each workload's proxy reaches through the lowerings of its
#: hinted motifs (``kernel_lowerings``); the lowering declines all four of
#: PageRank's
PATH_KERNELS = {"kmeans": MAIN_PATH_KERNELS, "terasort": ("bitonic_sort",),
                "pagerank": (), "alexnet": ("matmul", "row_moments"),
                "inception_v3": ("matmul", "row_moments")}

#: the workloads phase: the other four workloads at SCALE (TeraSort 2M
#: records, PageRank 262,144 vertices and 4,194,304 edges, AlexNet batch
#: 128 at 32x32x3, Inception-V3 batch 32 at 75x75x3)
WORKLOAD_NAMES = ("terasort", "pagerank", "alexnet", "inception_v3")

#: the card's step against the host's on the same inputs.  PageRank's
#: per-vertex f32 sums run in another order (atomics on the card, one
#: pass on the host) over up to ~860,000 in-edges of a hub: at scale 1.0
#: the host's own hub sum is 2.4e-3 off its float64 value, and a sum of n
#: terms in a random order moves by ~sqrt(n)·2^-24 ≈ 5.5e-5 of itself; a
#: vertex of average in-degree 16 that lost one edge would move by 6 %.
#: The AI steps: loss and new params at 2e-4, with TF32 allowed around
#: the card's call, so that a step that took it is caught.
PAGERANK_TOL = dict(rtol=1e-3, atol=1e-9)
AI_STEP_TOL = dict(rtol=2e-4, atol=2e-5)

#: the main path's size: K-means at full scale (400,000 x 64 f32 points,
#: 32 centroids), tuned for the reference generate_proxy's default
#: ``max_iters``
SCALE = 1.0
MAX_ITERS = 24

#: the paper_repro phase's size: the reference benchmark's own defaults
#: (``benchmarks/paper_repro.py``: ``--scale 0.5 --iters 40``), uncut
PAPER_SCALE = 0.5
PAPER_ITERS = 40

#: the case_studies phase's tuning iterations: the reference's default
#: (``benchmarks/case_studies.py --iters 16``); each case's sizes are its
#: function's defaults, the reference's
CASE_ITERS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> "SystemExit":
    return SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> tuple:
    """(ms, kernels) a call: the device kernels' summed time and their
    count over one ``torch.profiler`` run of ``iters`` back-to-back calls,
    divided by ``iters``; (None, None) where the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None, None
    return (sum(_device_ms(e) for e in kernels) / iters,
            sum(e.count for e in kernels) / iters)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same function
# ---------------------------------------------------------------------------


def bound(kind: str, args) -> tuple:
    """(bound_ms, bound_by, bytes_ms) for one kernel call, from its
    inputs: bytes_ms is the byte time alone, which bound_ms takes when
    it is the larger."""
    ops, nbytes, peak = work(kind, args)
    return bound_of(ops / peak, nbytes / HBM_BYTES_PER_S)


def bound_of(t_ops: float, t_bytes: float) -> tuple:
    """(bound_ms, bound_by, bytes_ms) from the operations' and the bytes'
    times in seconds."""
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", t_bytes * 1e3)


def work(kind: str, args) -> tuple:
    """(operations, bytes, peak operations a second) of one kernel call:
    each input read once, each output written once."""
    import math

    if kind == "matmul":
        x, y = args
        (m, k), n = x.shape, y.shape[1]
        es = x.element_size()
        ops = 2.0 * m * n * k
        nbytes = (m * k + k * n + m * n) * es
        peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    elif kind == "row_moments":
        (x,) = args
        d = x.shape[-1]
        r = x.numel() // d
        ops = 2.0 * r * d
        nbytes = x.numel() * x.element_size() + 2 * r * 4
        peak = PEAK_FLOPS["float32"]
    elif kind == "rmsnorm":  # x², sum, ·rsqrt, ·w: 4 flops an element
        x, w = args
        ops = 4.0 * x.numel()
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        peak = PEAK_FLOPS["float32"]
    elif kind == "flash_attention":  # the pairs the mask keeps
        from repro_torch.kernels.flash_attention import flops

        q, k, v, causal = args
        ops = flops(q, k, causal)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    elif kind == "moe_dispatch":  # the dense contraction over tokens
        mask, x = args
        (t, e, c), d = mask.shape, x.shape[1]
        ops = 2.0 * t * e * c * d
        nbytes = (mask.numel() * mask.element_size()
                  + (x.numel() + e * c * d) * x.element_size())
        peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    else:  # bitonic_sort: read n keys, write the padded runs
        x, block = args
        n = x.shape[0]
        n_pad = n + (-n) % block
        # a comparison sort of each run needs about log2(block) compares
        # per key: the function's work, not the bitonic network's
        ops = float(n) * math.log2(block)
        nbytes = (n + n_pad) * x.element_size()
        peak = PEAK_FLOPS["float32"]
    return ops, nbytes, peak


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(torch, dev) -> dict:
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    u = torch.randint(-(1 << 31), 1 << 31, (1024,), dtype=torch.int32,
                      device=dev).view(torch.uint32)
    probes = {
        "sort": lambda: torch.sort(u),
        "argsort_stable": lambda: torch.argsort(u, stable=True),
        "index": lambda: u[torch.arange(8, device=dev)],
        "xor": lambda: u ^ torch.ones((), dtype=torch.uint32, device=dev),
        "amin": lambda: torch.amin(u),
        "searchsorted": lambda: torch.searchsorted(torch.sort(u).values, u),
        "cat": lambda: torch.cat([u, u]),
        "full": lambda: torch.full((4,), 7, dtype=torch.uint32, device=dev),
        "eq": lambda: u == u,
        "to_int64": lambda: u.to(torch.int64),
        "to_float32": lambda: u.to(torch.float32),
        "from_int64": lambda: u.to(torch.int64).to(torch.uint32),
    }
    support = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            support[name] = True
        except (NotImplementedError, RuntimeError) as e:
            support[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
    log(f"uint32 on the card: {json.dumps(support)}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(compiled={_build.BUILD_INFO['compiled']})")
    report = Path(_build.BUILD_INFO["path"]).with_name("ptxas.txt")
    if report.exists():
        text = report.read_text()
        for line in ptxas_summary(text):
            log(f"  ptxas: {line}")
        spilled = {src: n for src in NO_SPILL
                   if (n := spill_bytes(text, src))}
        if spilled:
            raise fail(f"ptxas spilled in {json.dumps(spilled)} (bytes of "
                       f"spill stores and loads)")
    return support


def spill_bytes(report: str, source: str) -> int:
    """Bytes of spill stores and loads ptxas reports for the kernels of
    one source (its ``== <source>`` section of the build's report)."""
    import re

    head = f"== {source}\n"
    if head not in report:
        raise fail(f"the build's ptxas report has no section for {source}")
    section = report.split(head, 1)[1].split("\n== ", 1)[0]
    return sum(int(n) for n in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", section))


def ptxas_summary(report: str) -> list:
    """One line per compiled kernel of ``nvcc -Xptxas -v``'s report: its
    (demangled where ``c++filt`` exists) name, registers and spills.
    ptxas prints a function's spill line before its register line.  Then
    every warning line, such as ptxas serialising wgmma."""
    import re
    import shutil

    kernels, name, spill, notes = [], None, "", []
    for line in report.splitlines():
        if "Performance Loss" in line or "warning" in line:
            notes.append(line.strip())
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line and name:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                kernels.append((name, m.group(1), spill))
                name = None
    names = [k[0] for k in kernels]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    short = [n.removeprefix("void ").replace("(anonymous namespace)::", "")
             .split("(")[0][:72] for n in names]
    return [f"{n}: {regs} registers; {spill}"
            for n, (_, regs, spill) in zip(short, kernels)] + notes


def launch_form(row: dict, wrapper, call):
    """``call()``, failing unless it launched the form ``row["form"]``
    names, once, on the wrapper's per-form counts."""
    before = dict(wrapper.forms)
    out = call()
    taken = [f for f, n in wrapper.forms.items() if n != before[f]]
    if taken != [row["form"]]:
        raise fail(f"{row['kernel']} {row['shape']}: expected the "
                   f"{row['form']} form, launched {taken}")
    return out


def check_kernel(torch, kind: str, args, iters: int = 20) -> dict:
    """One kernel against its plain version on the same inputs, timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import (bitonic_sort, flash_attention, matmul,
                                     moe_dispatch, ref, rmsnorm)
    from repro_torch.uint32 import bits, full

    typed = args[1] if kind == "moe_dispatch" else args[0]  # x, not mask
    row = {"kernel": kind, "shape": [list(a.shape) if hasattr(a, "shape")
                                     else a for a in args],
           "dtype": str(typed.dtype).replace("torch.", "")}
    if kind == "matmul":
        x, y = args
        row["form"] = matmul.form(x, y)
        call = lambda: matmul.matmul(x, y)  # noqa: E731
        got = launch_form(row, matmul.matmul, call)
        want = ref.matmul(x, y)
        tol = TOL[(kind, row["dtype"])]
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        row["ms"] = time_ms(torch, call, iters)
        row["plain_ms"] = time_ms(torch, lambda: ref.matmul(x, y), iters)
        row["library_ms"] = time_ms(torch, lambda: torch.matmul(x, y), iters)
    elif kind == "row_moments":
        (x,) = args
        row["form"] = rmsnorm.form(x)
        call = lambda: rmsnorm.row_moments(x)  # noqa: E731
        gm, gq = launch_form(row, rmsnorm.row_moments, call)
        wm, wq = ref.row_moments(x)
        tol = TOL[(kind, row["dtype"])]
        err = max((gm - wm).abs().max().item(), (gq - wq).abs().max().item())
        torch.testing.assert_close(gm, wm, **tol)
        torch.testing.assert_close(gq, wq, **tol)
        # the same input gives the same bits, call after call
        again = call()
        if not (torch.equal(again[0], gm) and torch.equal(again[1], gq)):
            raise fail(f"row_moments {row['shape']} {row['dtype']}: two calls "
                       f"on the same input differ ({row['form']} form)")
        row["ms"] = time_ms(torch, call, iters)
        row["plain_ms"] = time_ms(torch, lambda: ref.row_moments(x), iters)
        row["library_ms"] = time_ms(
            torch, lambda: torch.var_mean(x, dim=-1, correction=0), iters)
    elif kind == "rmsnorm":
        x, w = args
        row["form"] = rmsnorm.rmsnorm_form(x)
        call = lambda: rmsnorm.rmsnorm(x, w)  # noqa: E731
        got = launch_form(row, rmsnorm.rmsnorm, call)
        want = ref.rmsnorm(x, w)
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[(kind, row["dtype"])])
        # the summation order is the launch shape's: the same bits again
        if not torch.equal(call(), got):
            raise fail(f"rmsnorm {row['shape']} {row['dtype']}: two calls on "
                       f"the same input differ ({row['form']} form)")
        row["ms"] = time_ms(torch, call, iters)
        row["plain_ms"] = time_ms(torch, lambda: ref.rmsnorm(x, w), iters)
        row["library_ms"] = time_ms(
            torch, lambda: F.rms_norm(x, (x.shape[-1],), w, eps=1e-6), iters)
        copy = torch.empty_like(x).copy_  # the same bytes read and written
        row["copy_ms"] = time_ms(torch, lambda: copy(x), iters)
        row["copy_device_ms"] = device_ms(torch, lambda: copy(x), iters)[0]
    elif kind == "flash_attention":
        q, k, v, causal = args
        fa = flash_attention.flash_attention
        row["form"] = flash_attention.form(q)
        call = lambda: fa(q, k, v, causal=causal)  # noqa: E731
        got = launch_form(row, fa, call)
        want = ref.flash_attention(q, k, v, causal)
        if not torch.isfinite(got).all():
            raise fail(f"flash_attention {row['shape']}: non-finite output")
        diff = (got.float() - want.float()).abs()
        tol = TOL[(kind, row["dtype"])]
        limit = tol["atol"] + tol["rtol"] * want.float().abs()
        if q.dtype == torch.bfloat16:
            limit += P_ROUNDING * ref.flash_attention(
                q.float(), k.float(), v.float().abs(), causal)
        err = diff.max().item()
        row["err_over_tol"] = (diff / limit).max().item()
        if row["err_over_tol"] > 1.0:
            worst = divmod(int((diff / limit).argmax()), q.shape[-1])[0]
            raise fail(f"flash_attention {row['shape']} {row['dtype']}: "
                       f"error {row['err_over_tol']:.3g}x its tolerance "
                       f"(max abs err {err}, worst at (b,s,h) row {worst})")
        del want, diff, limit
        row["ms"] = time_ms(torch, call, iters)
        row["plain_ms"] = time_ms(
            torch, lambda: ref.flash_attention(q, k, v, causal), iters)
        # SDPA's is_causal keeps k <= q from the top left, as the reference
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        row["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters)
    elif kind == "moe_dispatch":
        mask, x = args
        row["form"] = moe_dispatch.form(x)
        row["mask_dtype"] = str(mask.dtype).replace("torch.", "")
        call = lambda: moe_dispatch.moe_dispatch(mask, x)  # noqa: E731
        got = launch_form(row, moe_dispatch.moe_dispatch, call)
        # the op casts the mask to x's type first, as the reference does
        want = ref.moe_dispatch(mask.to(x.dtype), x)
        one_hot = bool(((mask == 0) | (mask == 1)).all()) and bool(
            (mask.sum((1, 2)) <= 1).all())
        row["exact"] = one_hot
        err = (got.float() - want.float()).abs().max().item()
        if one_hot and not torch.equal(got, want):
            raise fail(f"moe_dispatch {row['shape']} {row['dtype']}: a "
                       f"one-hot mask gave a result that differs from the "
                       f"plain version (max abs err {err})")
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[(kind, row["dtype"])])
        del want
        row["ms"] = time_ms(torch, call, iters)
        row["plain_ms"] = time_ms(torch, lambda: ref.moe_dispatch(mask, x),
                                  iters)
        mask_x = mask.to(x.dtype)
        row["library_ms"] = time_ms(
            torch, lambda: torch.einsum("tec,td->ecd", mask_x, x), iters)
    else:
        x, block = args
        sentinel = bitonic_sort.SENTINELS[x.dtype]
        call = lambda: bitonic_sort.bitonic_sort_blocks(  # noqa: E731
            x, block=block)
        got = call()
        want = ref.sort_blocks(x, block, sentinel)
        if not torch.equal(got, want):
            bad = (bits(got) != bits(want)).nonzero()
            raise fail(f"bitonic_sort {row['dtype']} n={x.shape[0]} "
                       f"block={block}: {bad.numel()} keys differ, first at "
                       f"{bad[:4].flatten().tolist()}")
        err = 0.0
        row["passes"] = f"tile {bitonic_sort.tile_for(block)}: " + ", ".join(
            f"{kind} {step}" for kind, step in bitonic_sort.bitonic_schedule(
                block, bitonic_sort.tile_for(block)))
        row["ms"] = time_ms(torch, call, iters)
        row["plain_ms"] = time_ms(
            torch, lambda: ref.sort_blocks(x, block, sentinel), iters)
        padded = torch.cat([x, full(((-x.shape[0]) % block,), sentinel,
                                    x.dtype, x.device)])
        if x.dtype == torch.uint32:
            # torch has no CUDA sort for uint32: sort the order-preserving
            # int32 image of the same keys (bits as int32, sign flipped),
            # built here, outside the timed call
            padded = padded.view(torch.int32) ^ -(1 << 31)
        row["library_ms"] = time_ms(
            torch, lambda: torch.sort(padded.view(-1, block), dim=-1), iters)
    row["max_abs_err"] = err
    row["device_ms"], row["device_kernels"] = device_ms(torch, call, iters)
    row["bound_ms"], row["bound_by"], row["bytes_ms"] = bound(kind, args)
    return row


def fmt_ms(v) -> str:
    return "n/a" if v is None else f"{v:.4f}"


def fmt_row(r: dict) -> str:
    def f(v):
        return "n/a" if v is None else f"{v:.4f}"
    used = (f" ({r['err_over_tol']:.3f} of tol)" if "err_over_tol" in r
            else "")
    if "mask_dtype" in r:
        form = f" [{r['mask_dtype']} mask, {r['form']}]"
    else:
        form = f" [{r['form']}]" if "form" in r else ""
    if "passes" in r:
        form = f" [{r['passes']}]"
    if "copy_ms" in r:
        form += f" copy_={f(r['copy_ms'])} (device {f(r['copy_device_ms'])})"
    return (f"  {r['kernel']:15s} {r['dtype']:9s} {str(r['shape']):42s} "
            f"err={r['max_abs_err']:.3g}{used} ms={f(r['ms'])} "
            f"device={f(r['device_ms'])} (kernels/call "
            f"{r['device_kernels']}) plain={f(r['plain_ms'])} lib={f(r['library_ms'])} "
            f"bound={f(r['bound_ms'])} ({r['bound_by']}; bytes "
            f"{f(r['bytes_ms'])}){form}")


def entry_point_cases(torch, dev, full: bool):
    """(kind, args, timing iterations, headline) of the entry-point
    kernels: ragged shapes, or (``full``) full-width shapes of models the
    repo supports — qwen3-4b's d_model 2560 and head_dim 128 over 32 heads
    (``src/repro/configs/qwen3_4b.py``) at the train_4k length,
    tinyllama-1.1b's head_dim 64, and deepseek-v2-lite-16b's MoE group
    (``configs/deepseek_v2_lite_16b.py``: group 4096, 64 experts, d_model
    2048, 6 experts a token at capacity factor 1.25, so capacity
    int(4096·6·1.25/64) = 480 by ``models/layers.py:561-563``; the mask
    routes seeded top-1 ids, as ``make_dispatch_mask`` takes one expert a
    token).  ``headline`` marks the one full-width case of each kernel
    that the kernels JSON reports.  Made from a fixed seed, one case at a
    time."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def routed(t, e, c):  # seeded top-1 ids through make_dispatch_mask
        ids = torch.randint(0, e, (t,), generator=g, device=dev)
        return ops.make_dispatch_mask(ids, e, c)

    if not full:
        for dtype in (f32, bf16):
            for r, d in ((33, 512), (8, 128), (5, 20_000)):
                yield "rmsnorm", (randn(r, d, dtype=dtype),
                                  randn(d, dtype=dtype)), 20, False
        # x and w of different types: the mixed forms rmsnorm.cu compiles
        yield "rmsnorm", (randn(33, 512, dtype=bf16), randn(512)), 20, False
        yield "rmsnorm", (randn(5, 20_000), randn(20_000, dtype=bf16)), 20, \
            False
        # the vector forms at model widths with rows that leave the last
        # group part-empty (16 lanes a row, a warp, a block), rows whose
        # bytes are off the 16-byte grid (2558 in bf16) and a base one
        # element off it: the scalar form
        for dtype in (f32, bf16):
            for r, d in ((1001, 128), (301, 2560), (9, 2558)):
                yield "rmsnorm", (randn(r, d, dtype=dtype),
                                  randn(d, dtype=dtype)), 20, False
            yield "rmsnorm", (randn(33 * 512 + 1, dtype=dtype)[1:].view(
                33, 512), randn(512, dtype=dtype)), 20, False
        for shape, causal in (((2, 130, 4, 64), True), ((2, 130, 4, 64), False),
                              ((1, 257, 2, 128), True),
                              ((1, 257, 2, 128), False),
                              ((1, 100, 2, 96), True)):
            yield "flash_attention", (randn(*shape), randn(*shape),
                                      randn(*shape), causal), 20, False
        yield "flash_attention", tuple(randn(2, 130, 4, 64, dtype=bf16)
                                       for _ in range(3)) + (True,), 20, False
        kv = (2, 130, 4, 64)  # Sq != Skv under the causal mask
        yield "flash_attention", (randn(2, 64, 4, 64), randn(*kv),
                                  randn(*kv), True), 20, False
        # bf16: the wgmma form at D = 64 and 128 (ragged, both masks, Sq
        # below and above Skv), the SIMT form at D = 96
        for qs, kvs, causal in (((2, 130, 4, 64), (2, 130, 4, 64), False),
                                ((1, 257, 2, 128), (1, 257, 2, 128), True),
                                ((1, 257, 2, 128), (1, 257, 2, 128), False),
                                ((2, 64, 4, 64), (2, 130, 4, 64), True),
                                ((1, 300, 2, 128), (1, 200, 2, 128), True),
                                ((1, 130, 2, 128), (1, 257, 2, 128), False),
                                ((1, 100, 2, 96), (1, 100, 2, 96), True)):
            yield "flash_attention", (randn(*qs, dtype=bf16),
                                      randn(*kvs, dtype=bf16),
                                      randn(*kvs, dtype=bf16), causal), 20, \
                False
        # base pointers off the 16-byte grid: the wgmma form's scalar loads
        n = 1 * 257 * 2 * 128
        yield "flash_attention", tuple(
            randn(n + 1, dtype=bf16)[1:].view(1, 257, 2, 128)
            for _ in range(3)) + (True,), 20, False
        for t, e, c, d in MOE_SMALL:
            for dtype in (f32, bf16):
                yield "moe_dispatch", (routed(t, e, c),
                                       randn(t, d, dtype=dtype)), 20, False
                # a dense mask, made in x's dtype so the cast is exact
                yield "moe_dispatch", (randn(t, e, c, dtype=dtype),
                                       randn(t, d, dtype=dtype)), 20, False
            # bf16 x with a one-hot bf16 mask and with a dense f32 one
            yield "moe_dispatch", (routed(t, e, c).to(bf16),
                                   randn(t, d, dtype=bf16)), 20, False
            yield "moe_dispatch", (randn(t, e, c), randn(t, d, dtype=bf16)), \
                20, False
        # a bf16 mask with f32 x
        yield "moe_dispatch", (randn(64, 8, 16, dtype=bf16),
                               randn(64, 32)), 20, False
        # base pointers off the 16-byte grid: the wgmma form's scalar loads
        # on shapes whose rows would allow vectors
        t, e, c, d = 128, 4, 64, 16
        for mask_dtype in (f32, bf16):
            yield "moe_dispatch", (
                randn(t * e * c + 1, dtype=mask_dtype)[1:].view(t, e, c),
                randn(t * d + 1, dtype=bf16)[1:].view(t, d)), 20, False
        return
    for dtype in (f32, bf16):
        yield "rmsnorm", (randn(32768, 2560, dtype=dtype),
                          randn(2560, dtype=dtype)), 20, dtype == bf16
    yield "rmsnorm", (randn(32768 * 32, 128, dtype=bf16),
                      randn(128, dtype=bf16)), 20, False
    for shape, dtype, iters, headline in (
            ((1, 4096, 32, 128), f32, 5, False),
            ((1, 4096, 32, 128), bf16, 10, True),
            ((1, 4096, 32, 64), bf16, 10, False)):
        yield "flash_attention", tuple(randn(*shape, dtype=dtype)
                                       for _ in range(3)) + (True,), iters, \
            headline
    # bf16 x with the routed f32 mask (the headline), the same mask cast
    # to bf16 first (like for like with einsum on the cast mask), f32
    mask = routed(4096, 64, 480)
    yield "moe_dispatch", (mask, randn(4096, 2048, dtype=bf16)), 20, True
    yield "moe_dispatch", (mask.to(bf16), randn(4096, 2048, dtype=bf16)), 20, \
        False
    yield "moe_dispatch", (mask, randn(4096, 2048)), 3, False


def sort_cases(torch, dev, g):
    """(args, timing iterations) of phase 2's bitonic sort cases: the main
    path's shape; blocks sharing a tile, one a tile, the 2^15 tile, global
    passes beyond it (2^16 to 2^20: one to four strides a pass, the merge
    variant's longest runs); ragged inputs; a base one element off the
    16-byte grid; in all four dtypes; then every block from 2 to 2^16 in
    uint32 (the main path's type).  Keys from the generator ``g``."""
    def keys(n, dtype, off=0):  # off: base that many elements past
        if dtype in (torch.uint32, torch.int32):
            x = torch.randint(-(1 << 31), 1 << 31, (n + off,), generator=g,
                              device=dev, dtype=torch.int32)
            x = x.view(torch.uint32) if dtype == torch.uint32 else x
        else:
            x = torch.randn(n + off, generator=g, device=dev).to(dtype)
        return x[off:]

    for dtype in (torch.uint32, torch.int32, torch.float32, torch.bfloat16):
        for n, block, off in ((9830, 2048, 0), (1 << 16, 4096, 0),
                              (100_003, 4096, 0), (100_003, 4096, 1),
                              (1 << 16, 256, 0), (1 << 18, 1 << 15, 0),
                              (1 << 18, 1 << 16, 0), (70_001, 1 << 15, 0),
                              ((1 << 18) + 3, 1 << 17, 0),
                              ((1 << 18) + 3, 1 << 18, 0),
                              ((1 << 19) + 3, 1 << 19, 0),
                              ((1 << 20) + 3, 1 << 20, 0)):
            yield (keys(n, dtype, off), block), 20
    for b in range(1, 17):
        yield (keys(3 * (1 << b) + 1, torch.uint32), 1 << b), 5


def phase_kernels(torch, dev) -> list:
    from repro_torch.kernels import matmul, rmsnorm

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def off_grid(*shape, dtype=torch.float32):  # base 4 or 2 bytes past
        n = 1
        for s in shape:
            n *= s
        return randn(n + 1, dtype=dtype)[1:].view(*shape)

    rows, failures = [], []

    def add(kind, args, iters=20, headline=None):
        """Check one case; a failing case is logged and the phase goes on,
        so one run shows every case that fails."""
        try:
            r = check_kernel(torch, kind, args, iters)
        except (AssertionError, SystemExit) as e:
            shape = [list(a.shape) if hasattr(a, "shape") else a
                     for a in args]
            what = " ".join(str(e).split())[:300]
            failures.append(f"{kind} {shape}: {what}")
            log(f"  FAILED {kind} {shape}: {what}")
            return
        if headline is not None:
            r["headline"] = headline
        log(fmt_row(r))
        rows.append(r)

    narrow, small = matmul.NARROW_N, matmul.NARROW_SMALL_M_N
    for dtype in (torch.float32, torch.bfloat16):
        # ragged small shapes; the main path's wide shapes; narrow N at
        # (65536, 2048) (N = 2 in f32 at K = 512: at K = 2048 torch.matmul
        # splits K there and is itself 1.3e-4 off the float64 product at
        # one output, past this TOL, so no kernel can be held to it, as
        # repro_torch.bench.thresholds shows); N either side of the
        # narrow bound from NARROW_FULL_M rows and below it; K off the
        # 16-byte unit (the wide form's scalar loads; a narrow N goes to
        # the wide form there)
        for m, k, n in ((300, 200, 150), (4096, 64, 32), (129, 65, 257),
                        (12288, 2048, 128), (32768, 2048, 128),
                        (65536, 2048 if dtype == torch.bfloat16 else 512, 2),
                        (65536, 2048, 8),
                        (65536, 2048, narrow), (65536, 2048, narrow + 1),
                        (4096, 512, small), (4096, 512, small + 1),
                        (300, 203, 150),
                        (4099, 67, 8)):
            add("matmul", (randn(m, k, dtype=dtype),
                           randn(k, n, dtype=dtype)))
        # base pointers off the 16-byte grid: the wide form's scalar loads,
        # at a wide and a narrow N
        for m, k, n in ((300, 256, 160), (4096, 256, 8)):
            add("matmul", (off_grid(m, k, dtype=dtype),
                           off_grid(k, n, dtype=dtype)))
    # the main path's shape; either side of the one-launch bounds (the
    # input's bytes, then the row's, in f32); an off-grid base; split
    # shapes (two calls held bit-equal in each row)
    d_one = rmsnorm.ONE_LAUNCH_BYTES // (4 * 4)
    d_row = rmsnorm.ONE_LAUNCH_ROW_BYTES // 4
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((1024, 57), (4, d_one), (4, d_one + 1), (16, d_row),
                      (16, d_row + 1), (64, 1 << 22), (33, 70_001)):
            add("row_moments", (randn(*shape, dtype=dtype),))
        add("row_moments", (off_grid(33, 4096, dtype=dtype),))
    for args, iters in sort_cases(torch, dev, g):
        add("bitonic_sort", args, iters)
    for full in (False, True):
        for kind, args, iters, headline in entry_point_cases(torch, dev,
                                                             full):
            add(kind, args, iters, headline)
    if failures:
        raise fail(f"{len(failures)} kernel case(s) failed: "
                   + "; ".join(failures))
    return rows


def run_generate(torch, dev, name: str, args):
    """``generate_proxy`` on workload ``name`` with ``substrate="hopper"``,
    every launch counter zeroed just before and read just after; logs the
    report.  Fails if a kernel ``PATH_KERNELS[name]`` names was never
    launched, or the tuned proxy lost a hinted motif."""
    from repro_torch.core.generator import generate_proxy
    from repro_torch.kernels import ops
    from repro_torch.workloads import WORKLOADS

    w = WORKLOADS[name]
    path = "the main path" if name == "kmeans" else f"{name}'s generate_proxy"
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    pb, rep = generate_proxy(w.step, *args, name=name, hints=w.hints,
                             max_iters=MAX_ITERS, run=True,
                             substrate="hopper", device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_report(name, pb, rep, seconds, counts, path)
    return pb, rep, counts, seconds


def check_report(name: str, pb, rep, seconds: float, counts: dict,
                 path: str) -> None:
    """Logs one ``generate_proxy`` report, its tuned nodes and the
    launches over its run; fails if a kernel ``PATH_KERNELS[name]`` names
    was never launched, or the tuned proxy lost a hinted motif."""
    from repro_torch.workloads import WORKLOADS

    hints = WORKLOADS[name].hints
    log(f"generate_proxy {name}: {seconds:.1f} s  {rep.summary()}")
    log(f"  qualified={rep.qualified} mean_accuracy={rep.mean_accuracy:.4f} "
        f"evals={rep.evals} iterations={rep.iterations} "
        f"real_wall_s={rep.real_wall_time} proxy_wall_s={rep.proxy_wall_time} "
        f"speedup={rep.speedup}")
    log(f"  engine: {json.dumps(dict(rep.engine_stats))}")
    log(f"  timing: real {json.dumps(dict(rep.real_timing))} proxy "
        f"{json.dumps(dict(rep.proxy_timing))}")
    log(f"  {'metric':22s} {'target':>14s} {'proxy':>14s} accuracy")
    for k in rep.target_metrics:
        log(f"  {k:22s} {rep.target_metrics[k]:14.6g} "
            f"{rep.proxy_metrics[k]:14.6g} {rep.per_metric_accuracy[k]:.4f}")
    for n in pb.nodes:
        p = n.p
        log(f"  node {n.id} {n.motif}/{n.variant} data_size={p.data_size} "
            f"chunk_size={p.chunk_size} num_tasks={p.num_tasks} "
            f"weight={p.weight:.3f} batch_size={p.batch_size} "
            f"height={p.height} width={p.width} channels={p.channels} "
            f"substrate={p.substrate}")
    log(f"launches over {path}: {json.dumps(counts)}")
    if not PATH_KERNELS[name]:
        log(f"  {name}: the hopper lowering declines every hinted variant "
            f"({', '.join(f'{h.motif}/{h.variant}' for h in hints)}), "
            f"so its proxy runs on stock ATen alone")
    missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
    if missing:
        raise fail(f"kernels never launched on {path}: {missing}")
    if not 0.0 <= rep.mean_accuracy <= 1.0:
        raise fail(f"{name}: mean accuracy {rep.mean_accuracy} outside "
                   f"[0, 1]")
    if {(n.motif, n.variant) for n in pb.nodes} != {
            (h.motif, h.variant) for h in hints}:
        raise fail(f"the tuned {name} proxy lost a hinted motif")


def phase_main_all(torch, dev) -> list:
    """The main path, its checks, its kernels at its shapes (the kernels
    JSON's first three rows) and its traces; returns the rows and the
    tuned proxy."""
    from repro_torch.workloads import WORKLOADS

    pb, rep, counts, args = phase_main(torch, dev)
    phase_checks(torch, dev, pb, args)
    entries = phase_main_shapes(torch, dev, pb, counts)
    trace_pair(torch, dev, "kmeans", lambda: WORKLOADS["kmeans"].step(*args),
               pb)
    return entries, pb


def phase_main(torch, dev):
    from repro_torch.workloads import WORKLOADS

    args = WORKLOADS["kmeans"].inputs(seed=0, scale=SCALE, device=dev)
    x, c = args
    log(f"kmeans inputs: x {tuple(x.shape)} {x.dtype} "
        f"({x.numel() * x.element_size() / 1e6:.1f} MB, "
        f"{(x == 0).float().mean().item():.3f} zeros), centroids "
        f"{tuple(c.shape)}")
    pb, rep, counts, _ = run_generate(torch, dev, "kmeans", args)
    for what, timing in (("step", rep.real_timing),
                         ("tuned proxy", rep.proxy_timing)):
        if timing.get("mode") != "graph":
            raise fail(f"the main path's K-means {what} was not timed as a "
                       f"captured CUDA graph: {json.dumps(dict(timing))}")
    return pb, rep, counts, args


def phase_checks(torch, dev, pb, args) -> None:
    """The workload's and the tuned proxy's outputs, by the repo's means."""
    from repro_torch.workloads import WORKLOADS

    step = WORKLOADS["kmeans"].step
    cents, counts, inertia = step(*args)
    x, c = args
    if tuple(cents.shape) != tuple(c.shape) or counts.shape[0] != c.shape[0]:
        raise fail("kmeans step returned the wrong shapes")
    if not (torch.isfinite(cents).all() and torch.isfinite(inertia)):
        raise fail("kmeans step returned non-finite values")
    if int(counts.sum().item()) != x.shape[0]:
        raise fail("kmeans counts do not add up to the point count")
    if not bool((counts[1:] >= counts[:-1]).all()):
        raise fail("kmeans clusters are not ordered by size")
    # the same step on the host, on the same points
    hc, hn, hi = step(x.cpu(), c.cpu())
    if not torch.equal(hn, counts.cpu()):
        raise fail("kmeans counts differ between the card and the host")
    torch.testing.assert_close(cents.cpu(), hc, rtol=1e-4, atol=1e-4)
    log(f"checks: kmeans step finite, counts sum {x.shape[0]}, "
        f"equal to the host's; inertia {inertia.item():.6g} "
        f"(host {hi.item():.6g})")
    check_substrates(torch, dev, pb)


def check_substrates(torch, dev, pb) -> None:
    """The tuned proxy's outputs on the kernels against its stock-PyTorch
    form on the same inputs."""
    vals = pb.lifted_values(dev)
    got = pb.build_eval_fn(dev)(0, vals)
    want = pb.with_substrate("torch").build_eval_fn(dev)(0, vals)
    for nid in got:
        for key, g in got[nid].items():
            wv = want[nid][key]
            if g.shape != wv.shape or g.dtype != wv.dtype:
                raise fail(f"{nid}.{key}: {g.shape}/{g.dtype} vs "
                           f"{wv.shape}/{wv.dtype}")
            if g.dtype.is_floating_point:
                if not torch.isfinite(g).all():
                    raise fail(f"{nid}.{key} is not finite")
                torch.testing.assert_close(g, wv, rtol=1e-3, atol=1e-3)
                detail = f"max|d|={(g - wv).abs().max().item():.3g}"
            elif key == "assign":  # distance near-ties may pick another id
                frac = (g != wv).float().mean().item()
                if frac > 1e-3:
                    raise fail(f"{nid}.assign differs on {frac:.2%} rows")
                detail = f"differs on {frac:.2e} of rows"
            else:
                if not torch.equal(g.cpu(), wv.cpu()):
                    raise fail(f"{nid}.{key} differs between substrates")
                detail = "equal"
            log(f"checks: {nid}.{key} {tuple(g.shape)} {g.dtype} hopper vs "
                f"torch: {detail}")


def _close(what: str, got, want, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` (on the card) against ``want`` (host);
    fails the run past ``|d| <= atol + rtol·|want|``."""
    g, w = got.detach().cpu().double(), want.detach().double()
    err = (g - w).abs()
    if not bool((err <= atol + rtol * w.abs()).all()):
        raise fail(f"{what}: card and host differ (max abs err "
                   f"{err.max().item():.3g}, rtol {rtol}, atol {atol})")
    return err.max().item()


def check_step(torch, name: str, args) -> None:
    """One step of workload ``name`` on the card against the same step on
    CPU copies of its inputs."""
    from torch.utils._pytree import tree_map

    from repro_torch.uint32 import bits, widen
    from repro_torch.workloads import WORKLOADS, inception_v3

    step = WORKLOADS[name].step
    if name == "inception_v3":
        # the card's and the host's generators differ: draw the head's
        # keep mask once, on the card, and give both steps the same mask
        params, images, labels, rng = args
        keep = inception_v3.keep_mask(params, images, rng)
        step, args = inception_v3.step_with_keep, (params, images, labels,
                                                  keep)
    host = tree_map(lambda t: t.cpu(), args)
    if name == "terasort":
        got, want = step(*args), step(*host)
        for what, g, w in zip(("keys", "payload", "offsets"), got, want):
            if not torch.equal(bits(g).cpu(), bits(w)):
                raise fail(f"terasort {what}: card and host differ")
        k = widen(got[0])
        if not bool((k[1:] >= k[:-1]).all()):
            raise fail("terasort keys are not sorted")
        log(f"checks: terasort step equal to the host's (keys, payload, "
            f"offsets), keys sorted, offsets {got[2][:4].tolist()}...")
        return
    if name == "pagerank":
        got, want = step(*args), step(*host)
        if not torch.equal(got[3].cpu(), want[3]):
            raise fail("pagerank in_deg: card and host differ")
        errs = [_close(f"pagerank {what}", g, w, **PAGERANK_TOL)
                for what, g, w in zip(("ranks", "top", "delta"), got, want)]
        rel = ((got[0].cpu().double() - want[0].double()).abs()
               / want[0].double().abs()).max().item()
        log(f"checks: pagerank step in_deg equal to the host's; ranks, top, "
            f"delta max abs err {errs} (ranks max rel err {rel:.3g}); "
            f"rank sum {got[0].sum().item():.6g}, top {got[1][:3].tolist()}")
        return
    # TF32 allowed around the card's call: the step must not take it
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        new, loss = step(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    hnew, hloss = step(*host)
    if not torch.isfinite(loss):
        raise fail(f"{name} loss is not finite")
    err = _close(f"{name} loss", loss, hloss, **AI_STEP_TOL)
    perr = max(_close(f"{name} new {k}", new[k], hnew[k],
                      **AI_STEP_TOL) for k in new)
    log(f"checks: {name} step with TF32 allowed: loss {loss.item():.6g} "
        f"(host {hloss.item():.6g}, |d| {err:.3g}); new params max |d| "
        f"{perr:.3g} over {len(new)} tensors")


def phase_workloads(torch, dev) -> tuple:
    """``generate_proxy`` on each of the other four workloads, its step held
    against the host's, its tuned proxy against the stock form, the path's
    kernels at the shapes the proxy gives them, and traces.  Returns
    ``{workload: launch counts over its generate_proxy}`` and the kernel
    rows."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.workloads import WORKLOADS

    launches, rows = {}, []
    for name in WORKLOAD_NAMES:
        w = WORKLOADS[name]
        args = w.inputs(seed=0, scale=SCALE, device=dev)
        ts = tree_leaves(args)
        log(f"{name} inputs: {len(ts)} tensors, "
            f"{sum(t.numel() * t.element_size() for t in ts) / 1e6:.1f} MB: "
            + ", ".join(f"{tuple(t.shape)} {str(t.dtype)[6:]}"
                        for t in ts[:4]) + (" ..." if len(ts) > 4 else ""))
        pb, rep, counts, _ = run_generate(torch, dev, name, args)
        launches[name] = counts
        check_step(torch, name, args)
        check_substrates(torch, dev, pb)
        rows += path_shapes(torch, dev, name, pb)
        trace_pair(torch, dev, name, lambda: w.step(*args), pb)
    return launches, rows


def phase_paper_repro(torch, dev, store_dir: str) -> tuple:
    """The port's paper-reproduction sweep (``repro_torch.bench.
    paper_repro``) as its command line runs it: every workload from its
    ``BASE_P`` at ``PAPER_SCALE`` and ``PAPER_ITERS`` through one
    ``EvalSession`` on the kernels (``substrate="hopper"``) backed by a
    ``ProxyStore`` in ``store_dir``, every launch counter zeroed just
    before.  Fails if a kernel of a workload's path never launched, the
    per-workload compiles do not sum to the session's, or the document
    lacks a key of the reference benchmark's.  Then a fresh session on the
    same store replays each tuned proxy: it must profile nothing, hit the
    store once for each distinct key, and give the sweep's metrics bit for
    bit.  Returns ``{workload: launches over its run}`` and ``{workload:
    tuned proxy}`` (the serve phase serves them from the store)."""
    from repro_torch.bench import paper_repro
    from repro_torch.core import EvalSession, ProxyStore, normalized_vector
    from repro_torch.kernels import ops
    from repro_torch.workloads import WORKLOADS

    launches, proxies, records = {}, {}, []
    session = EvalSession(run=True, seed=0, substrate="hopper",
                          device=dev, store=ProxyStore(store_dir))
    torch.cuda.synchronize()
    ops.reset_launches()
    before = ops.launch_counts()
    t_sweep = time.perf_counter()
    for name in sorted(WORKLOADS):
        pb, rep, wall = paper_repro.run_one(
            name, PAPER_SCALE, PAPER_ITERS, session=session, device=dev)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        before = after
        check_report(name, pb, rep, wall, launches[name],
                     f"paper_repro's {name}")
        proxies[name] = pb
        records.append(paper_repro.record(name, PAPER_SCALE, pb, rep,
                                          wall))
    doc = {"workloads": records, "session": paper_repro.session_doc(
        session, time.perf_counter() - t_sweep)}
    missing = paper_repro.missing_keys(doc)
    if missing:
        raise fail(f"the paper_repro document lacks {missing}")
    stats = session.stats()
    log(f"paper_repro session: {json.dumps(stats)}")
    log(f"  cross_workload_hits={session.cross_workload_hits}")
    for name, delta in session.workload_stats.items():
        log(f"  workload_stats {name}: {json.dumps(delta)}")
    summed = sum(d["compiles"] for d in session.workload_stats.values())
    if summed != stats["compiles"]:
        raise fail(f"per-workload compiles sum to {summed}, the "
                   f"session's are {stats['compiles']}")
    log(f"  sweep: {doc['session']['total_tuning_wall_s']:.1f} s; " +
        "; ".join(f"{r['workload']} qualified={r['qualified']} "
                  f"mean={r['mean_accuracy']:.4f} "
                  f"speedup={r['speedup']}" for r in records))

    replay = EvalSession(run=True, seed=0, substrate="hopper",
                         device=dev, store=ProxyStore(store_dir))
    for name, pb in proxies.items():
        want = normalized_vector(session.signature_of(pb),
                                 include_rates=True)
        if replay.evaluate(pb) != want:
            raise fail(f"store replay of {name}'s proxy: metrics differ "
                       f"from the sweep's")
    got = replay.stats()
    distinct = len({replay.cache.key_for(pb) for pb in proxies.values()})
    log(f"store replay: {json.dumps(got)} ({distinct} distinct keys)")
    if got["compiles"] != 0 or got["store_hits"] != distinct:
        raise fail(f"store replay made {got['compiles']} compiles and "
                   f"{got['store_hits']} store hits for {distinct} "
                   f"distinct keys (want 0 and {distinct})")
    return launches, proxies


def _class_rows(metrics: dict) -> str:
    """A server's per-class count, P50/P95/P99, TTFR and its batches."""
    rows = [f"{c} n={r['count']} p50={r['p50_s']:.6f} p95={r['p95_s']:.6f} "
            f"p99={r['p99_s']:.6f} ttfr={r['ttfr_s']} s"
            for c, r in metrics["classes"].items()]
    return "; ".join(rows) + f"; batches {json.dumps(metrics['batches'])}"


def phase_serve(torch, dev, work: Path, proxies: dict) -> dict:
    """The serving path, every launch counter zeroed just before and read
    after the last server's shutdown.

    (a) ``repro_torch.bench.serve_bench --check`` in-process at the
    reference's defaults (8 shape classes, 4 clients x 12 requests, 1
    tune, open loop at 4 and 16 req/s) on the kernels, with a store (its
    warm-start probe is a child process on the card) and a trace, then
    ``repro_torch.bench.trace_summary --check`` on the trace.

    (b) a ``ProxyServer`` over a ``run=True`` hopper ``EvalSession`` on
    the sweep's store: one tune of K-means at phase 3's size (``SCALE``,
    ``MAX_ITERS``; the points built before the submit), then 4 closed-loop
    clients x 12 requests (every fifth a signature) over the sweep's
    ``proxies`` and the K-means proxy just tuned.  Fails if an evaluate
    differs by a bit from a serial session's on the same store, a sweep
    proxy was profiled rather than read from the store, the server
    counted an error, or matmul, row moments or bitonic sort never
    launched over the phase.  Returns the launches over the phase."""
    from repro_torch.bench import serve_bench, trace_summary
    from repro_torch.core import EvalSession, ProxyStore
    from repro_torch.kernels import ops
    from repro_torch.runtime import ProxyServer
    from repro_torch.workloads import WORKLOADS

    torch.cuda.synchronize()
    ops.reset_launches()

    # (a) the reference's bench, uncut ------------------------------------
    bench_dir = work / "serve_bench"
    out, trace = work / "serve_bench.json", bench_dir / "trace.json"
    rc = serve_bench.main(["--check", "--store", str(bench_dir), "--trace",
                           str(trace), "--device", "cuda", "--substrate",
                           "hopper", "--out", str(out)])
    if rc != 0:
        raise fail(f"serve_bench --check returned {rc}")
    doc = json.loads(out.read_text())
    missing = serve_bench.missing_keys(doc)
    if missing:
        raise fail(f"the serve_bench document lacks {missing}")
    warm = doc["warm"]
    log(f"serve_bench cold: {doc['cold']['wall_s']:.3f} s, "
        f"{json.dumps(doc['cold']['batches'])}")
    log(f"serve_bench warm: {warm['wall_s']:.3f} s, "
        f"{warm['throughput_rps']:.1f} req/s, errors {warm['errors']}; "
        + _class_rows(warm))
    log(f"serve_bench tune: {json.dumps(doc['tune'])}")
    for row in doc["open_loop"]:
        log(f"serve_bench open loop {row['rate_rps']:g} req/s: achieved "
            f"{row['achieved_rps']:.2f}, n={row['count']} "
            f"p50={row['p50_s']:.6f} p95={row['p95_s']:.6f} "
            f"p99={row['p99_s']:.6f} ttfr={row['ttfr_s']} s, batches "
            f"{json.dumps(row['batches'])}")
    log(f"serve_bench trace: {json.dumps(doc['trace'])}")
    log(f"serve_bench parity {json.dumps(doc['parity'])}, probe "
        f"{json.dumps(doc['warm_start_probe'])}, engine "
        f"{json.dumps(doc['engine'])}")
    rc = trace_summary.main([str(trace), "--check", "--top", "5"])
    if rc != 0:
        raise fail(f"trace_summary --check returned {rc}")
    torch.cuda.synchronize()
    bench_counts = ops.launch_counts()
    log(f"launches over serve_bench: {json.dumps(bench_counts)}")

    # (b) full-width traffic on the sweep's store --------------------------
    w = WORKLOADS["kmeans"]
    args = w.inputs(seed=0, scale=SCALE, device=dev)
    torch.cuda.synchronize()
    store_dir = str(work / "sweep_store")
    session = EvalSession(run=True, seed=0, substrate="hopper", device=dev,
                          store=ProxyStore(store_dir))
    with ProxyServer(session) as server:
        t0 = time.perf_counter()
        pb, rep = server.submit_tune(w.step, *args, name="kmeans",
                                     hints=w.hints,
                                     max_iters=MAX_ITERS).result()
        tune_s = time.perf_counter() - t0
    tuned = server.metrics()
    after_tune = ops.launch_counts()
    check_report("kmeans", pb, rep, tune_s,
                 {k: after_tune[k] - bench_counts[k] for k in after_tune},
                 "the served K-means tune")
    log(f"served tune: {_class_rows(tuned)}")

    served = dict(proxies, kmeans_served=pb)
    names, pool = list(served), list(served.values())
    before = session.stats()
    with ProxyServer(session) as server:
        t0 = time.perf_counter()
        results = serve_bench.closed_loop(server, pool, clients=4,
                                          per_client=12)
        wall = time.perf_counter() - t0
    m = server.metrics()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    delta = {k: v - before.get(k, 0) for k, v in session.stats().items()}
    log(f"served traffic: {48 / wall:.1f} req/s over {wall:.3f} s; "
        + _class_rows(m))
    log(f"  engine {json.dumps(m['engine'])}; over the traffic "
        f"{json.dumps(delta)}")
    serial = EvalSession(run=True, seed=0, substrate="hopper", device=dev,
                         store=ProxyStore(store_dir))
    want = [serial.evaluate(p) for p in pool]
    bad = [names[i] for i, got in results if got != want[i]]
    profiled = [n for n, p in proxies.items()
                if session.cache._entries[session.cache.key_for(p)].fn
                is not None]
    log(f"  {len(results)} evaluates against the serial session "
        f"({json.dumps(serial.stats())}): {len(bad)} differ")
    log(f"launches over the serve phase: {json.dumps(counts)}")
    if bad:
        raise fail(f"served evaluates differ from the serial session's: "
                   f"{sorted(set(bad))}")
    if profiled or delta["compiles"] != 0:
        raise fail(f"sweep proxies profiled rather than read from the "
                   f"store: {profiled}; {delta['compiles']} profiles over "
                   f"the traffic")
    if tuned["errors"] or m["errors"]:
        raise fail(f"the server counted {tuned['errors'] + m['errors']} "
                   f"errors")
    if len(results) != 40 or m["requests"] != 48:
        raise fail(f"{m['requests']} requests served, {len(results)} "
                   f"evaluates (want 48 and 40)")
    missing = [k for k in MAIN_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise fail(f"kernels never launched in the serve phase: {missing}")
    return counts


class _Recorder:
    """Records the inputs the port's kernel ops receive (one run)."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.kernels import ops

        # each wrapper is named like its custom op
        by_op = {k.wrapper.__name__: name for name, k in ops.KERNELS.items()}
        calls = self.calls = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "repro_torch":
                    name = by_op[func.overloadpacket.__name__]
                    kept = tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args)
                    size = sum(a.numel() for a in kept
                               if isinstance(a, torch.Tensor))
                    if name not in calls or size > calls[name][0]:
                        calls[name] = (size, kept)
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def path_shapes(torch, dev, name: str, pb) -> list:
    """Each kernel of workload ``name``'s path on the largest inputs its
    tuned proxy gives it, against its plain version, timed, with its
    bound."""
    from repro_torch.kernels import ops

    rec = _Recorder(torch)
    vals = pb.lifted_values(dev)
    with rec.mode:
        pb.build_eval_fn(dev)(0, vals)
    rows = []
    for kernel in PATH_KERNELS[name]:
        if kernel not in rec.calls:
            raise fail(f"the tuned {name} proxy gave {kernel} no input")
        args = rec.calls[kernel][1]
        if kernel == "matmul":
            args = tuple(args[:2])
        elif kernel == "row_moments":
            args = (args[0],)
        r = check_kernel(torch, kernel, tuple(args), iters=50)
        log(f"{name} path shape:" + fmt_row(r)[1:])
        if r.get("form") == "one_launch":
            check_one_launch(torch, r, args[0])
        r["workload"] = name
        rows.append(r)
    return rows


def check_one_launch(torch, r: dict, x) -> None:
    """Fails unless row moments' one-launch form runs one device kernel a
    call.  The profiler may miss kernels of the 50 profiled calls (0.98
    and 0.22 a call seen on correct single launches), never invent them:
    a count under one a call is profiled again, up to twice more, and the
    last count decides; two or more a call fails at once."""
    from repro_torch.kernels import rmsnorm

    seen = [r["device_kernels"] or 0]
    while round(seen[-1]) == 0 and len(seen) < 3:
        seen.append(device_ms(torch, lambda: rmsnorm.row_moments(x), 50)[1]
                    or 0)
    if len(seen) > 1:
        log(f"  row_moments at {r['shape']}: device kernels a call over "
            f"each profile {seen}")
    if round(seen[-1]) != 1:
        raise fail(f"row_moments at {r['shape']} (one-launch form) ran "
                   f"{seen} device kernels a call")


def phase_main_shapes(torch, dev, pb, counts) -> list:
    """Each main-path kernel on the largest inputs the tuned proxy gives
    it: the kernels JSON's rows for them."""
    return [kernel_entry(r["kernel"], counts[r["kernel"]], r)
            for r in path_shapes(torch, dev, "kmeans", pb)]


def kernel_entry(name: str, launches: int, r: dict) -> dict:
    """One kernel's item of the kernels JSON line."""
    from repro_torch.kernels import ops

    kernel = ops.KERNELS[name]
    return {"name": name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"]}


def phase_bench(torch, dev, kernel_rows) -> list:
    """The entry point's path: ``kernels_bench --check`` on the card, then
    each new kernel's ``ops`` entry point at the full-width shapes, with
    every launch counter zeroed just before and read just after."""
    import tempfile

    from repro_torch.bench import kernels_bench
    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "kernels_bench.json")
        torch.cuda.synchronize()
        ops.reset_launches()
        rc = kernels_bench.main(["--check", "--out", out])
        if rc != 0:
            raise fail(f"kernels_bench --check returned {rc}")
        calls = {"rmsnorm": lambda x, w: ops.rmsnorm(x, w),
                 "flash_attention": lambda q, k, v, c: ops.flash_attention(
                     q, k, v, causal=c),
                 "moe_dispatch": lambda m, x: ops.moe_dispatch(m, x)}
        for kind, args, _, _ in entry_point_cases(torch, dev, full=True):
            y = calls[kind](*args)
            if not torch.isfinite(y).all():
                shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
                raise fail(f"ops.{kind} at {shapes} gave non-finite values")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        forms = {name: dict(k.wrapper.forms) for name, k in ops.KERNELS.items()
                 if hasattr(k.wrapper, "forms")}
        doc = json.loads(Path(out).read_text())
    log(f"kernels_bench: {len(doc['rows'])} rows, parity "
        f"{json.dumps(doc['parity'])}, cache {json.dumps(doc['cache'])}, "
        f"device {json.dumps(doc['device'])}")
    log(f"launches over the bench phase: {json.dumps(counts)}")
    for name, by_form in forms.items():
        log(f"{name} launches by form: {json.dumps(by_form)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise fail(f"kernels never launched in the bench phase: {missing}")
    for name, by_form in forms.items():
        if by_form.get("wgmma") == 0:
            raise fail(f"{name}'s tensor-core form never launched")
    entries = []
    for name in ops.KERNELS:
        if name in MAIN_PATH_KERNELS:
            continue
        rows = [r for r in kernel_rows
                if r["kernel"] == name and r.get("headline")]
        if len(rows) != 1:
            raise fail(f"{name} has {len(rows)} headline rows in phase 2")
        entries.append(kernel_entry(name, counts[name], rows[0]))
    return entries


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0.0)
    return us / 1e3


def phase_trace(torch, dev, name: str, fn) -> dict:
    """Wall time of ``fn`` eagerly (median of 5 dispatches, no profiler)
    and as the port times it (``timed_wall``: median of 5 replays of one
    captured CUDA graph, or eager where the capture fails), and one
    profiled run for the device's busy time (sum of its kernels) and top
    kernels.  Returns ``{"eager_ms", "timed_ms", "timing", "busy_ms"}``."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.signature import timed_wall

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    seconds, timing = timed_wall(fn, iters=5, device=dev)
    out = {"eager_ms": wall_ms, "timed_ms": seconds * 1e3, "timing": timing,
           "busy_ms": None}
    walls_text = (f"wall eager {wall_ms:.3f} ms (median of 5, no profiler), "
                  f"timed {out['timed_ms']:.3f} ms ({json.dumps(timing)})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"trace {name}: {walls_text}; device time not measured (the "
            f"profiler saw no kernel)")
        return out
    busy = out["busy_ms"] = sum(_device_ms(e) for e in kernels)
    log(f"trace {name}: {walls_text}; device busy {busy:.3f} ms = "
        f"{busy / wall_ms:.1%} of the eager wall, "
        f"{busy / out['timed_ms']:.1%} of the timed one, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=_device_ms, reverse=True)[:6]:
        log(f"  {_device_ms(e):9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return out


def trace_pair(torch, dev, name: str, step_fn, pb) -> None:
    """Traces of workload ``name``'s step and its tuned proxy ``pb`` (the
    eval form the engine times), and the step-over-proxy speedup from the
    eager walls and from the timed ones."""
    step = phase_trace(torch, dev, f"{name} step", step_fn)
    vals = pb.lifted_values(dev)
    proxy_fn = pb.build_eval_fn(dev)
    proxy = phase_trace(torch, dev, f"{name} tuned proxy",
                        lambda: proxy_fn(0, vals))
    log(f"speedup {name}: eager {step['eager_ms'] / proxy['eager_ms']:.4f}, "
        f"timed {step['timed_ms'] / proxy['timed_ms']:.4f} (step "
        f"{step['timing']['mode']}, proxy {proxy['timing']['mode']})")


def phase_case_studies(torch, dev, work: Path) -> dict:
    """The port's §IV case studies through their command line, one case a
    call, at the reference's defaults with ``--substrate hopper``, every
    launch counter zeroed just before and read after each case.  Fails
    if case A never launched a main-path kernel, case B never launched
    the sort (its TeraSort proxy), or a document lacks a reference key.
    Returns ``{case: launch counts over it}``."""
    from repro_torch.bench import case_studies
    from repro_torch.kernels import ops

    launches, records = {}, []
    torch.cuda.synchronize()
    ops.reset_launches()
    before = ops.launch_counts()
    for case in ("a", "b", "c"):
        out = work / f"case_{case}.json"
        t0 = time.perf_counter()
        rc = case_studies.main(["--case", case, "--iters", str(CASE_ITERS),
                                "--substrate", "hopper", "--device", "cuda",
                                "--out", str(out)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise fail(f"case_studies --case {case} returned {rc}")
        (record,) = json.loads(out.read_text())
        records.append(record)
        after = ops.launch_counts()
        launches[case] = {k: after[k] - before[k] for k in after}
        before = after
        log(f"case {case} ({record['case']}): {seconds:.1f} s, launches "
            f"{json.dumps(launches[case])}")
        if case == "a":
            log(f"  sparse_mean_acc={record['sparse_mean_acc']:.4f} "
                f"dense_mean_acc={record['dense_mean_acc']:.4f} "
                f"({record['conclusion']}); dense per metric "
                f"{json.dumps(record['dense_per_metric'])}")
        elif case == "b":
            for name in ("terasort", "pagerank"):
                r = record[name]
                log(f"  {name}: orig_mean_acc={r['orig_mean_acc']:.4f} "
                    f"newcfg_mean_acc={r['newcfg_mean_acc']:.4f}")
        else:
            log(f"  generations {record['generations']}: trend_consistent="
                f"{record['trend_consistent']}")
            log(f"  real_order {record['real_order']}, ratios "
                f"{json.dumps(record['real_ratios'])}")
            log(f"  proxy_order {record['proxy_order']}, ratios "
                f"{json.dumps(record['proxy_ratios'])}")
        timings = record.get("timing") or {
            f"{w}.{k}": t for w in ("terasort", "pagerank")
            for k, t in record.get(w, {}).get("timing", {}).items()}
        for what, timing in timings.items():
            log(f"  timing {what}: {json.dumps(timing)}")
    missing = case_studies.missing_keys(records)
    if missing:
        raise fail(f"the case_studies documents lack {missing}")
    never = [k for k in MAIN_PATH_KERNELS if launches["a"][k] == 0]
    if never:
        raise fail(f"case A never launched {never}")
    if launches["b"]["bitonic_sort"] == 0:
        raise fail("case B's TeraSort never launched the bitonic sort")
    return launches


#: phase 6g's runs of ``repro_torch.bench.scenario_matrix`` (each starts
#: ``SCENARIO_RANKS`` ranks that share the card, gloo between them), at
#: the reference's defaults (``--scale 0.2 --iters 8``, the four default
#: scenarios): (label, workloads, the run's own flags, whether it runs
#: ``--check``, the kernels each rank must launch).  The re-tunes under
#: each mesh run on K-means and PageRank, the population bench with
#: them.  Not cut for time: at ``--iters 6`` the re-tunes took as long
#: (they stop before their budget) and the lighter K-means proxy's
#: population bench no longer gained from 4 ranks (0.98x, failing its
#: gate; 1.44-2.00x at 8).  The AI workloads run without ``--check``: at
#: scale 0.2 AlexNet's batch of 25 divides no mesh and Inception-V3's of
#: 6 not dp4's, so those steps run whole on every rank and move no
#: collective, as the reference's do not, and the reference's gate "zero
#: real-workload collective bytes" would fail them; this phase holds
#: their other gates itself, and a step whose inputs split must move
#: collective bytes.
SCENARIO_RANKS = 4
SCENARIO_COMMON = ["--scenarios", "single,dp2,dp4,dp2_mp2", "--scale", "0.2",
                   "--iters", "8"]
SCENARIO_RUNS = (
    ("retune", "kmeans,pagerank", ["--tune-under-mesh", "--pop", "32"],
     True, MAIN_PATH_KERNELS),
    ("terasort", "terasort", ["--pop", "0"], True, ("bitonic_sort",)),
    ("ai", "alexnet,inception_v3", ["--pop", "0"], False,
     ("matmul", "row_moments")),
)
#: seconds one scenario run's ranks may take
SCENARIO_TIMEOUT = 600


def phase_scenarios(torch, dev, work: Path) -> dict:
    """The cluster scenarios: ``scenario_matrix --device cuda --substrate
    hopper`` (``SCENARIO_RUNS``), each run ``SCENARIO_RANKS`` ranks
    sharing the card, its launch counters fresh in every rank.  Logs,
    per workload and scenario, the collective bytes by kind of the step
    and the proxy and how each wall was taken; per rank its kernel
    launches and device-memory peak.  Fails if a run fails its
    ``--check`` (nonzero collectives on every multi-device scenario,
    ``single`` bit-identical to the serial engine, the re-tunes' and the
    population bench's gates, the hopper proxy's outputs equal to the
    stock form's on dp2); for the run without it, if any of those but
    the step's collectives fails; if a step moved collective bytes
    exactly when its inputs did not split; or if a rank of a run never
    launched a kernel its workloads' proxies lower onto.  Returns ``{kernel:
    {run: [launches per rank]}}``."""
    import os

    launches = {k: {} for k in MAIN_PATH_KERNELS}
    env = dict(os.environ, PYTHONPATH=str(SRC),
               REPRO_EMU_DEVICES=str(SCENARIO_RANKS))
    for label, workloads, extra, check, kernels in SCENARIO_RUNS:
        out = work / f"scenario_{label}.json"
        cmd = ([sys.executable, "-m", "repro_torch.bench.scenario_matrix",
                "--device", "cuda", "--substrate", "hopper", "--out",
                str(out), "--timeout", str(SCENARIO_TIMEOUT), "--workloads",
                workloads] + SCENARIO_COMMON + extra
               + (["--check"] if check else []))
        log(f"scenario run {label}: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, env=env, timeout=SCENARIO_TIMEOUT + 60
                            ).returncode
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise fail(f"scenario_matrix run {label} returned {rc} after "
                       f"{seconds:.1f} s")
        doc = json.loads(out.read_text())
        log(f"scenario run {label}: {seconds:.1f} s, {doc['devices']} ranks")
        for rec in doc["workloads"]:
            name = rec["workload"]
            for c in rec["per_scenario"]:
                log(f"  {name}/{c['scenario']}: acc "
                    f"{c['mean_accuracy']:.4f}; step collectives "
                    f"{json.dumps(c['real_collectives'])} "
                    f"({c['real_timing'].get('mode')}); proxy collectives "
                    f"{json.dumps(c['proxy_collectives'])} "
                    f"({c['proxy_timing'].get('mode')}); walls "
                    f"{c['real_wall_s']} / {c['proxy_wall_s']} s")
                mt = c.get("mesh_tuned")
                if mt is not None:
                    log(f"    mesh-tuned acc {mt['mean_accuracy']:.4f} "
                        f"qual {mt['qualification_rate']:.2f} "
                        f"-> {mt['selected']}")
                multi = c["scenario"] != "single"
                if multi and c["proxy_collective_bytes"] <= 0:
                    raise fail(f"{name}/{c['scenario']}: no proxy "
                               f"collective bytes")
                if (c["real_collective_bytes"] > 0) != c["real_sharded"]:
                    raise fail(f"{name}/{c['scenario']}: step collective "
                               f"bytes {c['real_collective_bytes']} with "
                               f"inputs split: {c['real_sharded']}")
            sub = doc.get("substrate_parity", {}).get(name)
            log(f"  {name}: parity {doc['parity'][name]}, hopper vs torch "
                f"on dp2 {sub}")
            if not doc["parity"][name]["bit_identical"]:
                raise fail(f"{name}: single differs from the serial engine")
            if sub is None or not sub["ok"]:
                raise fail(f"{name}: the hopper proxy differs from the "
                           f"stock form on dp2 ({sub})")
        if "population_bench" in doc:
            log(f"  population bench: {json.dumps(doc['population_bench'])}")
        for r in doc["ranks"]:
            log(f"  rank {r['rank']}: launches {json.dumps(r['launches'])}, "
                f"device memory peak allocated "
                f"{r.get('max_allocated_bytes', 0) / 2**30:.2f} GiB, "
                f"reserved {r.get('max_reserved_bytes', 0) / 2**30:.2f} GiB")
            never = [k for k in kernels if r["launches"][k] == 0]
            if never:
                raise fail(f"scenario run {label}: rank {r['rank']} never "
                           f"launched {never}")
        for k in MAIN_PATH_KERNELS:
            launches[k][label] = [r["launches"][k] for r in doc["ranks"]]
    return launches


#: phase 6h: ``repro_torch.bench.stress_matrix`` at full size in
#: ``STRESS_RANKS`` ranks sharing the card, each case's status over every
#: rank the reference's (``typed_failure`` for these three, ``completed``
#: for the other seven)
STRESS_RANKS = 4
STRESS_TYPED = ("indivisible_mesh", "oversubscribed_mesh",
                "fault_exhausts_retries")
#: seconds the stress_matrix run's ranks, and the phase's own group, may take
STRESS_TIMEOUT = 600
#: (b): the reference test's pipeline (microbatches, rows, width) over
#: the ``STRESS_RANKS`` ranks as stages, ``tanh(h @ w)`` (and the tree
#: form ``tanh(h @ w + b)``), against the sequential oracle on one rank:
#: the largest difference within the reference test's atol (the two run
#: the same products, so on the card they agree to the bit)
PIPE_SHAPE = (8, 2, 16)
PIPE_TOL = 1e-5
#: (c): the state saved sharded on dp4 and restored onto dp2 (dp4 less two
#: ranks) and onto one rank, exactly: its shapes and placements
CKPT_STATE = {"w": ((4096, 256), "float32", "shard"),
              "count": ((), "int64", "replicate"),
              "v": ((1024,), "bfloat16", "shard")}


def stress_group_args():
    """``repro_torch.bench.stress_group.pipeline_and_restore``'s inputs
    for (b) and (c), from a seed: the pipeline's weights, biases and
    microbatches, the state and its placements on dp4."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard

    num_mb, rows, width = PIPE_SHAPE
    g = np.random.default_rng(24)
    w = (g.standard_normal((STRESS_RANKS, width, width)) * 0.3).astype(
        np.float32)
    b = g.standard_normal((STRESS_RANKS, 1, width)).astype(np.float32)
    x = g.standard_normal((num_mb, rows, width)).astype(np.float32)
    state, split = {}, {}
    for k, (shape, dtype, how) in CKPT_STATE.items():
        v = (torch.from_numpy(np.asarray(g.integers(-2**62, 2**62, shape)))
             if dtype == "int64"
             else torch.from_numpy(g.standard_normal(shape).astype(
                 np.float32)).to(getattr(torch, dtype)))
        state[k] = v
        split[k] = (Shard(0),) if how == "shard" else (Replicate(),)
    return w, b, x, state, split


def phase_stress(torch, dev, work: Path) -> dict:
    """The stress tier: (a) ``stress_matrix --check --device cuda
    --substrate hopper`` at full size, a child process of
    ``STRESS_RANKS`` ranks sharing the card (launch counters fresh in
    every rank); (b) and (c) in a group running ``stress_group``.  Logs
    each case's status, each rank's launches and device-memory peak.
    Fails if a gate fails, a case's status on any rank is not the
    reference's, the skew sweep took more than one profile, the fault
    case did not recover once, the device drop did not fail typed at one
    and replay on (1, 2), a rank never launched the bitonic sort, the
    pipeline differs from the oracle, a restore is not exact, or the
    runner did not recover once.
    Returns ``{kernel: [launches per rank]}`` over (a)."""
    import os

    from repro_torch.bench import stress_group
    from repro_torch.bench.stress_matrix import STRESS_CASES
    from repro_torch.distributed.launch import spawn

    out = work / "stress.json"
    env = dict(os.environ, PYTHONPATH=str(SRC),
               REPRO_EMU_DEVICES=str(STRESS_RANKS))
    cmd = [sys.executable, "-m", "repro_torch.bench.stress_matrix",
           "--check", "--device", "cuda", "--substrate", "hopper",
           "--out", str(out), "--timeout", str(STRESS_TIMEOUT)]
    log(f"stress run: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, env=env, timeout=STRESS_TIMEOUT + 60
                        ).returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise fail(f"stress_matrix returned {rc} after {seconds:.1f} s")
    run = json.loads(out.read_text())["runs"][-1]
    log(f"stress run: {seconds:.1f} s, {run['devices']} ranks, gates "
        f"{json.dumps(run['gates'])}")
    if run["devices"] != STRESS_RANKS or not all(run["gates"].values()):
        raise fail(f"stress gates: {run['gates']} {run['failures']}")
    for r in run["ranks"]:
        if [c["case"] for c in r["results"]] != list(STRESS_CASES):
            raise fail(f"rank {r['rank']} ran {len(r['results'])} cases")
        for c in r["results"]:
            want = ("typed_failure" if c["case"] in STRESS_TYPED
                    else "completed")
            if c["status"] != want:
                raise fail(f"rank {r['rank']}: {c['case']} {c['status']} "
                           f"({c.get('error', '')}), want {want}")
    cases = {c["case"]: c for c in run["cases"]}
    for name, c in cases.items():
        log(f"  {name}: {c['status']} "
            + json.dumps({k: v for k, v in c.items() if k not in (
                "case", "kind", "must_fail", "status", "balanced_spans")}))
    drop = cases["device_drop_requalify"]
    if cases["zipf_skew_sweep"]["compiles"] != 1:
        raise fail("the skew sweep took more than one profile")
    if cases["fault_injection_restore"]["recoveries"] != 1:
        raise fail("the fault case did not recover exactly once")
    if ("drop1_typed_error" not in drop or drop["replay_under"]["devices"]
            != 2 or drop["replay_under"]["mesh_shape"] != [1, 2]):
        raise fail(f"the device drop: {drop}")
    launches = {}
    for r in run["ranks"]:
        log(f"  rank {r['rank']}: launches {json.dumps(r['launches'])}, "
            f"device memory peak allocated "
            f"{r['max_allocated_bytes'] / 2**30:.2f} GiB, reserved "
            f"{r['max_reserved_bytes'] / 2**30:.2f} GiB")
        if r["launches"]["bitonic_sort"] == 0:
            raise fail(f"stress rank {r['rank']} never launched the sort")
        for k, n in r["launches"].items():
            launches.setdefault(k, []).append(n)

    t0 = time.perf_counter()
    ranks = spawn(stress_group.pipeline_and_restore, STRESS_RANKS, "cuda",
                  *stress_group_args(), "dp4", str(work / "stress_ckpt"),
                  device_type="cuda", timeout_s=STRESS_TIMEOUT)
    log(f"stress group (pipeline, elastic restore, runner): "
        f"{time.perf_counter() - t0:.1f} s")
    for r in ranks:
        run = r["runner"]
        log(f"  rank {r['rank']}: pipeline max abs err {r['pipe_err']:.3g} "
            f"(tree {r['pipe_tree_err']:.3g}), restores {r['restore']}, "
            f"runner recoveries {run['recoveries']}, {r['seconds']:.1f} s, "
            f"device memory peak allocated "
            f"{r['max_allocated_bytes'] / 2**30:.3f} GiB")
        if max(r["pipe_err"], r["pipe_tree_err"]) > PIPE_TOL:
            raise fail(f"rank {r['rank']}: the pipeline differs from "
                       f"gpipe_reference by {r['pipe_err']} "
                       f"(tree {r['pipe_tree_err']})")
        checks = {k: v for k, v in r["restore"].items() if k != "step"}
        if (r["restore"]["step"] != stress_group.SAVE_STEP
                or not all(checks.values())):
            raise fail(f"rank {r['rank']}: a restore is not exact: "
                       f"{r['restore']}")
        if (run["final_step"] != 5 or run["recoveries"] != 1
                or not run["sharded"] or (run["w"] != 5.0).any()):
            raise fail(f"rank {r['rank']}: the runner on dp4: {run}")
    if sum("dp2_whole" in r["restore"] for r in ranks) != 2:
        raise fail("dp2's two ranks did not both restore")
    return launches


#: the model phase (6i): the zoo's serving path at full width and depth
#: (qwen3-4b: 36 layers, d_model 2560, 32 query and 8 KV heads of 128,
#: d_ff 9728, vocab 151,936, qk-norm, tied embeddings; about 4.02 B f32
#: params from ``MODEL_SEED``, bf16 activations): a prefill of
#: ``MODEL_BATCH`` x ``MODEL_PROMPT`` tokens, ``pad_caches`` to
#: ``MODEL_PROMPT + MODEL_STEPS``, then ``MODEL_STEPS`` greedy decode steps
MODEL_NAME = "qwen3-4b"
MODEL_SEED = 0
MODEL_BATCH, MODEL_PROMPT, MODEL_STEPS = 4, 1024, 32
#: (b): the same width at ``MODEL_HOST_LAYERS`` layers in f32, TF32 off,
#: the card against the port on the host with the same weights and tokens
MODEL_HOST_LAYERS = 2
MODEL_HOST_PROMPT, MODEL_HOST_STEPS = 128, 4
#: (a)'s tolerance, each step's logits (and the prefill's) against the
#: teacher-forced forward's at that position: rtol one bf16 rounding,
#: atol this fraction of the forward logits' standard deviation (about
#: 1.01 = 0.02 sqrt(2560)).  A decode step rounds to bf16 after products
#: of another shape than the forward's (4 tokens against 4,224), at each
#: of the 36 layers; measured on the H100: 0.118 at most, 11.7 % of the
#: deviation, so the allowance is about twice that.  Greedy tokens may
#: still differ at near ties (argmax agreement is logged, not held).
MODEL_BF16_ATOL_STD = 0.25
MODEL_BF16_RTOL = 2.0 ** -7
#: (b)'s tolerance: f32 sums of up to 9,728 terms in another order on the
#: card and on the host, through two layers and the logits (measured:
#: 1.2e-5 at most, logits of std about 1)
MODEL_F32_TOL = dict(rtol=1e-4, atol=1e-4)
#: (a'): an MoE model with multi-head latent attention at full width and
#: depth, deepseek-v2-lite-16b (27 layers, d_model 2048, 16 heads; MLA
#: kv_lora 512, rope 64, nope 128, v 128, no q-LoRA; layer 0 dense of
#: d_ff 10,944, then 26 MoE layers of 64 routed experts of width 1408,
#: top 6, and 2 shared; capacity factor 1.25, groups of 4096 tokens;
#: vocab 102,400; 15,706,484,224 f32 params = 62.8 GB from
#: ``MODEL_SEED``, bf16 activations).  The prompt is 992 tokens so that
#: the prefill's 4 x 992 tokens form one MoE group and the teacher-forced
#: forward over the prompt and the 32 fed tokens exactly one, 4 x 1024 =
#: 4096: past one group the reference requires whole groups.  (b'): its
#: width at ``MODEL_HOST_LAYERS`` layers (one dense, one MoE), as (b).
MOE_MODEL_NAME = "deepseek-v2-lite-16b"
MOE_BATCH, MOE_PROMPT, MOE_STEPS = 4, 992, 32
#: (a')'s bf16 tolerance, as (a)'s but atol this fraction of the forward
#: logits' std (about 1.0).  In bf16 a decode step's MoE input differs by
#: rounding from the forward's, a token at a near tie of its router then
#: takes another expert, and over 26 MoE layers that moves the logits far
#: more than in a dense model: measured on the H100, 1.11 x the std at
#: most, on two runs alike.  So this bf16 check catches only gross
#: faults, and the f32 oracle below holds the same path closely.
MOE_BF16_ATOL_STD = 2.0
#: (a'') the oracle again in f32 at full width and depth (params are f32
#: already, so nothing is cast), ``F32_ORACLE_BATCH`` rows of the same
#: prompt at the no-drop capacity, each step within ``F32_ORACLE_TOL`` of
#: the f32 forward at its position: f32 products of other shapes than the
#: forward's, summed in another order (measured on the H100: 2.1e-5 at
#: most, argmax agreeing at every position); (c)-(e) run it too
F32_ORACLE_BATCH = 1
F32_ORACLE_TOL = dict(rtol=1e-4, atol=1e-4)
#: (c)-(e): the zoo's last three families at full width and depth, params
#: from ``MODEL_SEED``, bf16 activations, each held to its teacher-forced
#: forward at ``MODEL_BF16_RTOL`` and its row's ``atol_std`` x the forward
#: logits' std, to the f32 forward as (a''), and as (b) in f32 against
#: the host.
#: (c) mamba2-780m: 48 SSD layers, d_model 1536, 48 heads of 64, state
#: 128, chunks of 256, vocab 50,280; 780,148,992 f32 params (3.1 GB); a
#: prompt of 1000, not a multiple of the chunk, so the padded chunk runs.
#: (d) recurrentgemma-9b: 38 layers, 12 (RG-LRU, RG-LRU, local attention)
#: superblocks and an unscanned (RG-LRU, RG-LRU) tail; d_model and LRU
#: width 4096, 16 query heads of 256 over 1 KV head, window 2048, vocab
#: 256,000; 9,396,408,320 f32 params (37.6 GB); a prompt of 2304, past
#: the window, so the local layers' caches are rings of 2048 and decode
#: wraps.  (e) whisper-small: 12 encoder and 12 decoder layers, d_model
#: 768, 12 heads of 64, vocab 51,865; 338,771,712 f32 params; 1500 frames
#: (30 s of audio after the stubbed stem's 2x stride) and a prompt of 32.
#: mamba2-780m's decode drifts from its forward over the steps, in bf16
#: and, less, in f32: each step's roundings enter the f32 SSD state,
#: which carries them into the next steps, at each of 48 layers, and the
#: forward's chunked scan takes differences of within-chunk cumulative
#: sums of ``dt * A`` over chunks of 256, which f32 holds to about 1e-7
#: of their size.  Measured on the H100: bf16 0.11 x the logits' std at
#: the first step, up to 1.49 x after 16 steps; f32 2.8e-4 at the first
#: step, up to 2.9e-3; the argmax agreeing at every f32 position.  So its
#: bf16 run is held at 2.0 x the std and its f32 oracle at atol 6e-3.
#: recurrentgemma-9b and whisper-small measured 0.19 x and 0.04 x the std
#: in bf16, 7.4e-5 and 3.3e-6 in f32, and keep the defaults.
#: Rows: (name, batch, prompt, steps, frames, atol_std, f32 oracle's tol)
FAMILY_RUNS = (
    ("mamba2-780m", 4, 1000, 32, 0, 2.0, dict(rtol=1e-4, atol=6e-3)),
    ("recurrentgemma-9b", 2, 2304, 32, 0, MODEL_BF16_ATOL_STD,
     F32_ORACLE_TOL),
    ("whisper-small", 4, 32, 32, 1500, MODEL_BF16_ATOL_STD, F32_ORACLE_TOL))


def profiled(torch, fn, top: int = 4):
    """``fn()`` under ``torch.profiler``: (its result, device busy ms (the
    kernels' summed time), kernel launches, the ``top`` kernels, the
    ``top`` ATen ops by the device time of the kernels they launched
    themselves)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    aten = [e for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith("aten::") and _device_ms(e) > 0]

    def lines(rows):
        return [f"{_device_ms(e):.3f} ms x{e.count} {e.key[:60]}"
                for e in sorted(rows, key=_device_ms, reverse=True)[:top]]
    return (out, sum(_device_ms(e) for e in kernels),
            sum(e.count for e in kernels), lines(kernels), lines(aten))


def serve_greedy(torch, model, params, prompt, steps: int, *,
                 tokens=None, extra=None, profile: bool = False) -> dict:
    """Prefill ``prompt`` (B, S) (with ``extra`` inputs beside it in the
    batch: Whisper's ``frames``), ``pad_caches`` to S + ``steps``, then
    ``steps`` decode steps fed greedily (or with ``tokens``, (B, steps)),
    each timed on the host clock to the device's end.  Returns the
    prefill's last logits (B, V) and seconds, each step's logits (B, V)
    and seconds, and the tokens fed (B, steps): step i's logits are
    position S + i's.  With ``profile`` (on the card) the prefill and the
    last step run under ``torch.profiler`` (:func:`profiled`), their
    results under ``"prefill_profile"`` and ``"step_profile"``."""
    from repro_torch.device import synchronize
    from repro_torch.runtime import (make_decode_step, make_prefill_step,
                                     pad_caches)

    dev = prompt.device
    B, S = prompt.shape
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    def call(name, fn, *args, trace=False):
        if not trace:
            return fn(*args)
        result, *out[name] = profiled(torch, lambda: fn(*args))
        return result

    out = {"steps": [], "step_s": [], "fed": []}
    synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = call("prefill_profile", prefill, params,
                          {"tokens": prompt, **(extra or {})},
                          trace=profile)
    synchronize(dev)
    out["prefill"], out["prefill_s"] = logits[:, 0], time.perf_counter() - t0
    caches = pad_caches(model, caches, B, S + steps)
    index = torch.full((), S, dtype=torch.int32, device=dev)
    for i in range(steps):
        t0 = time.perf_counter()
        tok = (logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
               if tokens is None else tokens[:, i:i + 1])
        logits, caches = call("step_profile", decode, params, caches,
                              {"tokens": tok, "index": index},
                              trace=profile and i == steps - 1)
        index = index + 1
        synchronize(dev)
        out["step_s"].append(time.perf_counter() - t0)
        out["steps"].append(logits[:, 0])
        out["fed"].append(tok)
    out["fed"] = torch.cat(out["fed"], dim=1)
    return out


def _pairs(S: int, window=None) -> int:
    """Query-key pairs a causal mask keeps over S positions (each
    position its last ``window`` ones, where given)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def serve_bounds(cfg, batch: int, prompt: int, frames: int = 0) -> dict:
    """The least ms the card could take for a prefill of (batch, prompt)
    (and ``frames`` encoder frames) and for one decode step after it,
    each (ms, bound_by): every input read once, every output written
    once.  Parameters are f32 and read whole, except a positional table
    (a row a position), and in decode the encoder (a step does not run
    it) and the routed experts a step's ``batch * k`` assignments cannot
    reach (``min(E, batch * k) / E`` of them are read).  Caches are read
    once and written once: K and V of each KV head (or MLA's ``kv_lora +
    rope`` latent), 2 bytes a value, over the positions a layer keeps (a
    local layer its window), and Whisper's cross K/V over the frames; a
    Mamba-2 layer's f32 state (H, P, N) and an RG-LRU layer's f32 ``h``,
    each with its bf16 conv tail, are read and written whole by a decode
    step and written by a prefill.  Operations at the bf16 rate: 2 an
    active parameter a token (routed experts: k of E), the last
    position's logits, attention's QK and PV over the pairs its mask keeps
    (causal, windowed, or every frame); at the f32 rate, the f32 products:
    RG-LRU's gates (``wa`` and ``wi``, 2 w^2 each a token) and SSD's
    (the causal pairs within each chunk times N + P, and 4 H P N a
    token)."""
    from repro_torch.models import build_model, count_params
    from repro_torch.models.trunk import _block_kind, build_segments

    meta = build_model(cfg).param_meta()
    n_all = count_params(meta)
    B, S, d = batch, prompt, cfg.d_model
    hd, H = cfg.resolved_head_dim(), cfg.num_heads
    pos = count_params(meta["embed"].get("pos", {}))  # positional tables
    if cfg.is_encoder_decoder:
        pos += count_params(meta["enc_pos"])
        kinds = ["global"] * cfg.num_layers
        n_run = count_params(meta["decoder"])
        n_enc = count_params(meta["encoder"]) + count_params(meta["enc_norm"])
    else:
        kinds = [k for seg in build_segments(cfg) for _ in range(seg.count)
                 for k in seg.kinds]
        n_run, n_enc = count_params(meta["trunk"]), 0
    routed = idle = gates = 0  # routed expert params; those a token
    reach = 1.0                # leaves idle; RG-LRU's f32 gate params
    if cfg.moe is not None:
        mo = cfg.moe
        per_expert = 3 * d * mo.d_ff
        n_moe = len(kinds) - min(mo.first_dense_layers, len(kinds))
        routed = n_moe * mo.num_experts * per_expert
        idle = n_moe * (mo.num_experts - mo.experts_per_token) * per_expert
        reach = min(mo.num_experts, B * mo.experts_per_token) / mo.num_experts
    cache = {"prefill": 0, "decode": 0}    # bytes of caches and states
    attn = {"prefill": 0.0, "decode": 0.0}  # bf16-rate attention ops
    f32_ops = {"prefill": 0.0, "decode": 0.0}
    for kind in kinds:
        mixer = _block_kind(cfg, kind)
        if mixer == "ssm":
            s_ = cfg.ssm
            d_in = s_.expand * d
            h_ = d_in // s_.head_dim
            conv_dim = d_in + 2 * s_.n_groups * s_.state_dim
            state = (B * h_ * s_.head_dim * s_.state_dim * 4
                     + B * (s_.conv_width - 1) * conv_dim * 2)
            cache["prefill"] += state
            cache["decode"] += 2 * state
            L_ = min(s_.chunk_size, S)
            f32_ops["prefill"] += (
                2.0 * B * h_ * (s_.state_dim + s_.head_dim)
                * ((S // L_) * _pairs(L_) + _pairs(S % L_))
                + 4.0 * B * S * h_ * s_.head_dim * s_.state_dim)
            f32_ops["decode"] += 4.0 * B * h_ * s_.head_dim * s_.state_dim
            continue
        if mixer == "recurrent":
            w = cfg.rglru.lru_width or d
            state = B * w * 4 + B * (cfg.rglru.conv_width - 1) * w * 2
            cache["prefill"] += state
            cache["decode"] += 2 * state
            gates += 2 * w * w
            f32_ops["prefill"] += 4.0 * B * S * w * w
            f32_ops["decode"] += 4.0 * B * w * w
            continue
        if mixer == "mla":
            m_ = cfg.mla
            kv = (m_.kv_lora_rank + m_.rope_head_dim) * 2
            qk, vd = m_.nope_head_dim + m_.rope_head_dim, m_.v_head_dim
        else:
            kv, qk, vd = 2 * cfg.num_kv_heads * hd * 2, hd, hd
        window = cfg.sliding_window if kind == "local" else None
        kept = min(S + 1, window) if window else S + 1
        cache["prefill"] += B * min(S, window or S) * kv
        cache["decode"] += B * kept * kv
        attn["prefill"] += 2.0 * B * _pairs(S, window) * H * (qk + vd)
        attn["decode"] += 2.0 * B * kept * H * (qk + vd)
        if cfg.is_encoder_decoder:  # cross attention over the frames
            cross = 2 * cfg.num_kv_heads * hd * 2
            cache["prefill"] += B * frames * cross
            cache["decode"] += B * frames * cross
            attn["prefill"] += 2.0 * B * S * frames * H * 2 * hd
            attn["decode"] += 2.0 * B * frames * H * 2 * hd
    if cfg.is_encoder_decoder:  # the encoder: every frame sees every one
        attn["prefill"] += (cfg.encoder_layers * 2.0 * B * frames * frames
                            * H * 2 * hd)
    active = n_run - idle - gates
    head = 2.0 * B * cfg.vocab_size * d
    bf, f32 = PEAK_FLOPS["bfloat16"], PEAK_FLOPS["float32"]
    decode_bytes = (4 * (n_all - pos - n_enc - routed) + 4 * routed * reach
                    + cache["decode"])
    decode_ops = 2.0 * B * active + head + attn["decode"]
    prefill_ops = (2.0 * B * S * active + 2.0 * B * frames * n_enc + head
                   + attn["prefill"])
    prefill_bytes = 4 * (n_all - pos + (S + frames) * d) + cache["prefill"]
    return {"decode": bound_of(decode_ops / bf + f32_ops["decode"] / f32,
                               decode_bytes / HBM_BYTES_PER_S)[:2],
            "decode_bytes": decode_bytes,
            "decode_cache_bytes": cache["decode"],
            "prefill": bound_of(prefill_ops / bf + f32_ops["prefill"] / f32,
                                prefill_bytes / HBM_BYTES_PER_S)[:2],
            "prefill_ops": prefill_ops + f32_ops["prefill"]}


def logit_errors(got, want, rtol: float, atol: float) -> dict:
    """(B, V) logits against the oracle's: max abs difference, the worst
    excess over ``atol + rtol |want|`` (> 0 fails), argmax agreement, and
    for each row whose argmax differs the oracle's top-1 minus top-2
    logit (``ties``: (row, gap) pairs)."""
    diff = (got.float() - want.float()).abs()
    excess = diff - (atol + rtol * want.float().abs())
    differs = got.argmax(-1) != want.argmax(-1)
    top2 = want.float().topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    return {"max_abs_err": float(diff.max()), "excess": float(excess.max()),
            "argmax_same": float((~differs).float().mean()),
            "ties": [(r, gaps[r]) for r in range(len(gaps))
                     if bool(differs[r])]}


class RouteLog:
    """While active, each call of the zoo's MoE layer records its tokens'
    top-k experts, ascending, on the device ((B, S, k)), in ``calls``,
    and the assignments its capacity drops in ``dropped`` (of
    ``assigned``).  The routing is recomputed beside the layer (f32
    router, softmax, top-k), so the run itself is unchanged; it is for
    the oracle runs, never for a timed one."""

    def __init__(self, torch):
        from repro_torch.models import layers

        self.torch, self.layers = torch, layers
        self.calls, self.dropped, self.assigned = [], [], 0

    def __enter__(self):
        torch, orig = self.torch, self.layers.moe_apply
        self.orig = orig

        def moe_apply(p, cfg, x):
            mo = cfg.moe
            logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
            top = torch.topk(torch.softmax(logits, dim=-1),
                             mo.experts_per_token, dim=-1).indices
            self.calls.append(top.sort(dim=-1).values.view(
                x.shape[0], x.shape[1], -1))
            T = top.shape[0]
            tg = min(mo.group_size, T)
            ids = top.view(T // tg, -1)
            counts = torch.zeros((ids.shape[0], mo.num_experts),
                                 dtype=torch.int64, device=x.device)
            counts.scatter_add_(1, ids, torch.ones_like(ids))
            cap = self.layers._capacity(mo, tg)
            self.dropped.append((counts - cap).clamp(min=0).sum())
            self.assigned += ids.numel()
            return orig(p, cfg, x)

        self.layers.moe_apply = moe_apply
        return self

    def __exit__(self, *exc):
        self.layers.moe_apply = self.orig


def routing_flips(torch, served, forward, steps: int) -> dict:
    """Where a served run's MoE routing differs from its teacher-forced
    forward's: ``served`` the :class:`RouteLog` calls of a prefill and
    ``steps`` decode steps, ``forward`` those of one forward over the same
    tokens, one call a MoE layer each.  A token's choice at a near tie of
    its router can flip with the bf16 rounding of its input, which
    differs between the prefill or a decode step and the forward.
    Returns the tokens that chose other experts at some layer and the
    (token, layer) pairs that did, each beside its total."""
    n = len(forward)
    got = [torch.cat([served[j]] + [served[n * (i + 1) + j]
                                    for i in range(steps)], dim=1)
           for j in range(n)]
    flips = torch.stack([(f != g).any(-1) for f, g in zip(forward, got)])
    tokens = flips.any(0)
    return {"layers": n, "tokens": int(tokens.sum()), "of": tokens.numel(),
            "token_layer_flips": int(flips.sum()),
            "of_pairs": flips.numel()}


def hold_to_forward(torch, model, params, prompt, run, rtol: float, *,
                    atol: float = None, atol_std: float = None,
                    routes=None, extra=None) -> tuple:
    """A served ``run`` of ``prompt`` held to ``model``'s teacher-forced
    ``forward`` over the prompt and the run's fed tokens: each step's
    logits and the prefill's against the forward's at that position,
    within ``rtol`` and ``atol`` (or ``atol_std`` x the forward logits'
    std).  The forward runs under ``routes`` (a :class:`RouteLog`) when
    given, with ``extra`` inputs beside the tokens.  Returns ({errors a
    position, atol, finite, forward seconds}, the forward's logits)."""
    S = prompt.shape[1]
    tokens = torch.cat([prompt, run["fed"]], dim=1)
    batch = {"tokens": tokens, **(extra or {})}
    t0 = time.perf_counter()
    if routes is None:
        forward, _ = model.forward(params, batch)
    else:
        with routes:
            forward, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    logits = [run["prefill"]] + run["steps"]
    finite = all(bool(torch.isfinite(x).all()) for x in logits + [forward])
    if atol is None:
        atol = atol_std * float(forward.std())
    errs = [logit_errors(x, forward[:, S - 1 + i], rtol, atol)
            for i, x in enumerate(logits)]
    return {"errs": errs, "atol": atol, "finite": finite,
            "forward_s": forward_s, "tokens": tokens}, forward


def frames_for(torch, dev, cfg, batch: int, frames: int, gen) -> dict:
    """An encoder-decoder's stub frame embeddings, (batch, frames,
    d_model) normal at 0.02 in the compute dtype, as the batch's
    ``frames``; ``{}`` for ``frames == 0``."""
    if not frames:
        return {}
    from repro_torch.data.generators import torch_dtype

    x = torch.empty((batch, frames, cfg.d_model), device=dev)
    x.normal_(0.0, 0.02, generator=gen)
    return {"frames": x.to(torch_dtype(cfg.dtype))}


def f32_oracle(torch, cfg, params, prompt, steps: int, extra: dict,
               report: dict, tol: dict = F32_ORACLE_TOL) -> tuple:
    """(a'') and those of (c)-(e): ``cfg`` in f32 (the params are f32
    already, so no weight is cast; TF32 is off) on ``F32_ORACLE_BATCH``
    rows of ``prompt`` (and of ``extra``), ``steps`` greedy steps held to
    the f32 forward at ``tol``.  Puts its largest error, its excess and
    ``tol`` into ``report``; returns (each position's errors, finite)."""
    from repro_torch.models import build_model

    model = build_model(cfg.replace(dtype="float32"))
    rows = prompt[:F32_ORACLE_BATCH]
    extra = {k: v[:F32_ORACLE_BATCH].float() for k, v in extra.items()}
    run = serve_greedy(torch, model, params, rows, steps, extra=extra)
    held, _ = hold_to_forward(torch, model, params, rows, run, tol["rtol"],
                              atol=tol["atol"], extra=extra)
    report["f32_oracle_tol"] = tol
    report["f32_oracle_max_abs_err"] = max(
        e["max_abs_err"] for e in held["errs"])
    report["f32_oracle_excess"] = max(e["excess"] for e in held["errs"])
    return held["errs"], held["finite"]


def serve_full(torch, dev, cfg, batch: int, prompt_len: int, steps: int,
               *, frames: int = 0, atol_std: float = MODEL_BF16_ATOL_STD,
               f32_tol: dict = None, oracle_cfg=None) -> tuple:
    """(a), (a') and (c)-(e): ``cfg`` at full width and depth on the card,
    params from ``MODEL_SEED``: a profiled warm-up prefill and 2 steps,
    then a timed prefill of ``batch`` x ``prompt_len`` (and ``frames``
    encoder frames for an encoder-decoder), ``pad_caches`` and ``steps``
    greedy decode steps, held to its teacher-forced forward
    (:func:`hold_to_forward`, ``MODEL_BF16_RTOL`` and ``atol_std`` x the
    forward logits' std), then with ``f32_tol`` the f32 oracle
    (:func:`f32_oracle`) at that tolerance.  With an MoE
    ``oracle_cfg`` (the same weights at a capacity that drops nothing) the
    timed run is not held; the oracle serves the prompt again under
    ``oracle_cfg`` and is held to its forward at ``MOE_BF16_ATOL_STD``,
    with where its routing differs from its forward's
    (:func:`routing_flips`), the assignments ``cfg``'s forward over the
    same tokens drops and its gap to the oracle's (neither held); then
    (a'') the f32 oracle under ``oracle_cfg``.  Returns the report, the
    held positions' errors (and the f32 oracle's, or ``[]``), and whether
    every logit was finite; frees the params."""
    import statistics

    from repro_torch.models import build_model, count_params

    B, S, T = batch, prompt_len, steps
    report = {"model": cfg.name, "batch": B, "prompt": S, "steps": T,
              "frames": frames}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(
        MODEL_SEED), device=dev)
    torch.cuda.synchronize()
    report["params"] = count_params(model.param_meta())
    report["init_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    extra = frames_for(torch, dev, cfg, B, frames, gen)
    warm = serve_greedy(torch, model, params, prompt, 2, extra=extra,
                        profile=True)
    timed = serve_greedy(torch, model, params, prompt, T, extra=extra)
    report["serve_peak_allocated_gb"] = (
        torch.cuda.max_memory_allocated(dev) / 1e9)
    f32_errs = []
    if oracle_cfg is None:
        held, forward = hold_to_forward(
            torch, model, params, prompt, timed, MODEL_BF16_RTOL,
            atol_std=atol_std, extra=extra)
        finite = held["finite"]
        del forward
        if f32_tol is not None:
            f32_errs, f32_finite = f32_oracle(torch, cfg, params, prompt, T,
                                              extra, report, f32_tol)
            finite = finite and f32_finite
    else:
        finite = all(bool(torch.isfinite(x).all())
                     for x in [timed["prefill"]] + timed["steps"])
        del timed["steps"]
        oracle_model = build_model(oracle_cfg)
        routes = RouteLog(torch)
        with routes:
            run = serve_greedy(torch, oracle_model, params, prompt, T)
        served, routes.calls = routes.calls, []
        held, forward = hold_to_forward(
            torch, oracle_model, params, prompt, run, MODEL_BF16_RTOL,
            atol_std=MOE_BF16_ATOL_STD, routes=routes)
        report["routing"] = routing_flips(torch, served, routes.calls, T)
        del served, routes, run
        # the shipped capacity's forward over the same tokens: its drops
        # and its gap to the no-drop forward (not held)
        shipped_routes = RouteLog(torch)
        with shipped_routes:
            shipped, _ = model.forward(params, {"tokens": held["tokens"]})
        report["shipped_dropped"] = int(sum(shipped_routes.dropped))
        report["shipped_assigned"] = shipped_routes.assigned
        report["capacity_gap_max_abs"] = float(
            (shipped - forward).abs().max())
        report["capacity_gap_argmax_same"] = float(
            (shipped.argmax(-1) == forward.argmax(-1)).float().mean())
        del shipped, shipped_routes, forward
        f32_errs, f32_finite = f32_oracle(torch, oracle_cfg, params, prompt,
                                          T, extra, report)
        finite = finite and held["finite"] and f32_finite
    report["forward_s"] = held["forward_s"]
    errs = held["errs"]
    steps_s = timed["step_s"]
    report.update({
        "cold_prefill_s": warm["prefill_s"], "prefill_s": timed["prefill_s"],
        "prefill_tokens_per_s": B * S / timed["prefill_s"],
        "decode_ms_a_token": statistics.median(steps_s[1:]) * 1e3,
        "prefill_busy_ms": warm["prefill_profile"][0],
        "prefill_kernels": warm["prefill_profile"][1],
        "prefill_top": warm["prefill_profile"][2],
        "decode_busy_ms": warm["step_profile"][0],
        "decode_kernels": warm["step_profile"][1],
        "decode_top": warm["step_profile"][2],
        "decode_first_ms": steps_s[0] * 1e3,
        "decode_tokens_per_s": B / statistics.median(steps_s[1:]),
        "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9,
        "bf16_atol": held["atol"],
        "bf16_max_abs_err": max(e["max_abs_err"] for e in errs),
        "bf16_excess": max(e["excess"] for e in errs),
        "argmax_same": min(e["argmax_same"] for e in errs),
        "bounds": serve_bounds(cfg, B, S, frames)})
    ties = [(S - 1 + i, r, g, e["max_abs_err"])
            for i, e in enumerate(errs) for r, g in e["ties"]]
    report["argmax_splits"] = {
        "positions": sum(1 for e in errs if e["ties"]), "rows": len(ties),
        "max_gap": max((g for _, _, g, _ in ties), default=None),
        "every_gap_under_the_error": all(g < err for _, _, g, err in ties)}
    del params, extra
    return report, errs, ties, f32_errs, finite


def host_check(torch, dev, cfg) -> tuple:
    """(b), (b') and those of (c)-(e): ``cfg`` at ``MODEL_HOST_LAYERS``
    layers in f32 (TF32 off by the caller; at least one whole layer
    pattern, so recurrentgemma-9b's three layers are one scanned
    superblock with its local layer; an encoder-decoder's encoder at
    ``MODEL_HOST_LAYERS`` too, over ``MODEL_HOST_PROMPT`` frames): a
    prefill of ``MODEL_HOST_PROMPT`` tokens and ``MODEL_HOST_STEPS``
    decode steps on the card, then the same weights and inputs through
    the port on the host.  Returns each position's errors
    (``MODEL_F32_TOL``) and the host's seconds."""
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_map

    small = cfg.replace(num_layers=max(MODEL_HOST_LAYERS,
                                       len(cfg.layer_pattern)),
                        dtype="float32")
    if cfg.is_encoder_decoder:
        small = small.replace(encoder_layers=MODEL_HOST_LAYERS)
    model = build_model(small)
    params = model.init(torch.Generator(device=dev).manual_seed(
        MODEL_SEED), device=dev)
    host_params = tree_map(lambda t: t.cpu(), params)
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED + 2)
    prompt = torch.randint(0, cfg.vocab_size, (1, MODEL_HOST_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    extra = frames_for(torch, dev, small, 1,
                       MODEL_HOST_PROMPT if cfg.is_encoder_decoder else 0,
                       gen)
    card_run = serve_greedy(torch, model, params, prompt, MODEL_HOST_STEPS,
                            extra=extra)
    t0 = time.perf_counter()
    host_run = serve_greedy(torch, model, host_params, prompt.cpu(),
                            MODEL_HOST_STEPS, tokens=card_run["fed"].cpu(),
                            extra={k: v.cpu() for k, v in extra.items()})
    host_s = time.perf_counter() - t0
    return [logit_errors(c.cpu(), h, **MODEL_F32_TOL) for c, h in zip(
        [card_run["prefill"]] + card_run["steps"],
        [host_run["prefill"]] + host_run["steps"])], host_s


def log_serving(card: str, r: dict, errs: list, ties: list, f32_errs: list,
                host_errs: list) -> None:
    """The lines of one model's serving run (a), its f32 oracle (a'') and
    its host check (b)."""
    name, b = r["model"], r["bounds"]
    frames = f" over {r['frames']} frames" if r["frames"] else ""
    log(f"  {name} on {card}: prefill {r['batch']}x{r['prompt']}{frames} "
        f"{r['prefill_tokens_per_s']:.0f} tokens/s "
        f"({r['prefill_s'] * 1e3:.1f} ms, bound {b['prefill'][0]:.2f} ms by "
        f"{b['prefill'][1]}), decode {r['decode_ms_a_token']:.2f} ms a token "
        f"(bound {b['decode'][0]:.2f} ms by {b['decode'][1]}: "
        f"{b['decode_bytes'] / 1e9:.3f} GB, "
        f"{b['decode_cache_bytes'] / 1e9:.4f} GB of it caches and states), "
        f"peak "
        f"{r['peak_allocated_gb']:.2f} GB allocated "
        f"({r['peak_reserved_gb']:.2f} reserved; the timed serving's "
        f"{r['serve_peak_allocated_gb']:.2f}, beside the f32 params' "
        f"{r['params'] * 4 / 1e9:.2f})")
    for stage in ("prefill", "decode"):
        log(f"  a {stage} under the profiler: device busy "
            f"{r[stage + '_busy_ms']:.2f} ms, {r[stage + '_kernels']} kernel "
            f"launches; top: {'; '.join(r[stage + '_top'])}")
    if "routing" in r:
        g = r["routing"]
        log(f"  routing: {g['tokens']} of {g['of']} tokens of the oracle run "
            f"chose other top-{r['k']} experts than its forward at some of "
            f"the {g['layers']} MoE layers ({g['token_layer_flips']} of "
            f"{g['of_pairs']} (token, layer) pairs); the shipped capacity's "
            f"forward over the same tokens drops {r['shipped_dropped']} of "
            f"{r['shipped_assigned']} assignments and differs from the "
            f"no-drop forward by {r['capacity_gap_max_abs']:.4g} (argmax "
            f"agreement {r['capacity_gap_argmax_same']:.4f}; not held)")
    for i, e in enumerate(errs):
        log(f"  {name} position {r['prompt'] - 1 + i}: max abs err "
            f"{e['max_abs_err']:.4g} (allowed {r['bf16_atol']:.4g} + "
            f"{MODEL_BF16_RTOL:.4g}|want|), argmax agreement "
            f"{e['argmax_same']:.2f}")
    for pos, row, gap, err in ties:
        log(f"  {name} argmax split at position {pos}, row {row}: the "
            f"forward's top-1 minus top-2 logit {gap:.4g}, the position's "
            f"max abs err {err:.4g} ({'a tie' if gap < err else 'NOT a tie'})")
    s = r["argmax_splits"]
    log(f"  {name} argmax splits: {s['rows']} rows at {s['positions']} "
        f"positions, largest gap {s['max_gap']}, every gap under its "
        f"position's error: {s['every_gap_under_the_error']}")
    for i, e in enumerate(f32_errs):
        log(f"  {name} f32 oracle, position {r['prompt'] - 1 + i}: max abs "
            f"err {e['max_abs_err']:.4g} ({r['f32_oracle_tol']}), argmax "
            f"agreement {e['argmax_same']:.2f}")
    for i, e in enumerate(host_errs):
        log(f"  {name} f32 card vs host, position {MODEL_HOST_PROMPT - 1 + i}"
            f": max abs err {e['max_abs_err']:.4g}")


def phase_model(torch, dev) -> dict:
    """The model zoo's serving path, with the launch counters zeroed just
    before and read just after.  (a) ``MODEL_NAME`` at full width and
    depth on the card (:func:`serve_full`): params from ``MODEL_SEED``,
    one warm-up prefill and decode steps, then a prefill of
    ``MODEL_BATCH`` x ``MODEL_PROMPT``, ``pad_caches`` and ``MODEL_STEPS``
    greedy decode steps, then a teacher-forced ``forward`` over the
    prompt and the fed tokens.  Fails on a non-finite logit, or a step or
    the prefill outside ``MODEL_BF16_*`` of the forward at its position.
    Logs prefill tokens/s, decode ms a token (median of the steps after
    the first) beside the bounds, and the device-memory peak.  (b) the
    same width at ``MODEL_HOST_LAYERS`` layers in f32 with TF32 off: the
    card against the port on the host, the same weights and tokens,
    within ``MODEL_F32_TOL`` (:func:`host_check`).  (a') and (b') the
    same for ``MOE_MODEL_NAME`` (``MOE_BATCH`` x ``MOE_PROMPT``,
    ``MOE_STEPS``), timed at its shipped capacity factor; its oracle run
    serves the same weights again at a capacity factor where no group of
    the run drops an assignment (``_capacity(mo, Tg) >= Tg``, asserted),
    since a forward group drops its overflow by design and a decode step
    never does.  (c)-(e) and theirs: ``FAMILY_RUNS`` (mamba2-780m,
    recurrentgemma-9b, whisper-small with its encoder frames) as (a) and
    (b).  Each run frees the previous one's params first.  For each row
    whose greedy token differs from the forward's argmax, the forward's
    top-1 minus top-2 logit is logged beside the position's error.  The
    six kernels' launches over the phase must be 0: the zoo keeps its own
    attention, norms, MoE dispatch and scans, as the reference's does.
    Returns ``{kernel: launches}``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import full_f32
    from repro_torch.kernels import ops
    from repro_torch.models.layers import _capacity

    card = card_line()
    torch.cuda.synchronize()
    ops.reset_launches()
    report = {"card": card}
    failures = []
    for name, B, S, T, frames, atol_std, f32_tol in (
            (MODEL_NAME, MODEL_BATCH, MODEL_PROMPT, MODEL_STEPS, 0,
             MODEL_BF16_ATOL_STD, None),
            (MOE_MODEL_NAME, MOE_BATCH, MOE_PROMPT, MOE_STEPS, 0,
             MOE_BF16_ATOL_STD, None),
            *FAMILY_RUNS):
        cfg = get_config(name)
        oracle_cfg = None
        if cfg.moe is not None:
            mo = cfg.moe
            oracle_cfg = cfg.replace(moe=dataclasses.replace(
                mo, capacity_factor=mo.num_experts / mo.experts_per_token
                + 0.01))
            for tg in (B * S, B * (S + T), B):  # prefill, forward, decode
                tg = min(mo.group_size, tg)
                if _capacity(oracle_cfg.moe, tg) < tg:
                    raise fail(f"{name}: the oracle's capacity drops in a "
                               f"group of {tg}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            r, errs, ties, f32_errs, finite = serve_full(
                torch, dev, cfg, B, S, T, frames=frames, atol_std=atol_std,
                f32_tol=f32_tol, oracle_cfg=oracle_cfg)
        if cfg.moe is not None:
            r["k"] = cfg.moe.experts_per_token
        torch.cuda.empty_cache()
        with torch.inference_mode(), full_f32():
            host_errs, r["host_s"] = host_check(torch, dev, cfg)
        torch.cuda.empty_cache()
        r["f32_max_abs_err"] = max(e["max_abs_err"] for e in host_errs)
        r["f32_excess"] = max(e["excess"] for e in host_errs)
        r["seconds"] = time.perf_counter() - t0
        report[name] = r
        log_serving(card, r, errs, ties, f32_errs, host_errs)
        if not finite:
            failures.append(f"{name}: non-finite logits")
        if r["bf16_excess"] > 0:
            failures.append(
                f"{name}: decode differs from the teacher-forced forward by "
                f"{r['bf16_max_abs_err']:.4g} (allowed {r['bf16_atol']:.4g} "
                f"+ {MODEL_BF16_RTOL:.4g}|want|)")
        if r.get("f32_oracle_excess", 0) > 0:
            failures.append(
                f"{name}: f32 decode differs from the f32 forward by "
                f"{r['f32_oracle_max_abs_err']:.4g} ({r['f32_oracle_tol']})")
        if r["f32_excess"] > 0:
            failures.append(
                f"{name} f32 at {MODEL_HOST_LAYERS}+ layers: the card "
                f"differs from the host by {r['f32_max_abs_err']:.4g} "
                f"({MODEL_F32_TOL})")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    report["launches"] = counts
    log("model serving: " + json.dumps(report))
    if any(counts.values()):
        failures.append(f"the zoo launched a kernel: {counts}")
    if failures:  # every run above is logged before the phase fails
        raise fail("; ".join(failures))
    return counts


#: the train phase (6j): the zoo's training path at full width and depth,
#: tinyllama-1.1b (arXiv:2401.02385: 22 layers, d_model 2048, 32 query
#: heads over 4 KV heads of 64, d_ff 5632, vocab 32,000, untied head;
#: ``TRAIN_PARAMS`` f32 params from ``TRAIN_SEED``, bf16 activations,
#: remat on as ``TrainSettings`` defaults it, AdamW's defaults with
#: ``warmup_cosine``): one warm-up step, then ``TRAIN_STEPS`` timed steps
#: of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens (its pretraining context)
#: from ``synthetic_lm_batch`` through ``DataPipeline``, straight through
#: ``make_train_step`` (``FaultTolerantRunner``'s blocking step-0 and
#: final saves would each write 13.2 GB of state)
TRAIN_NAME = "tinyllama-1.1b"
TRAIN_SEED = 0
TRAIN_PARAMS = 1_100_048_384
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 6
#: random weights: the step-0 loss lies within this of ln(vocab)
TRAIN_LOSS_BAND = 1.5
#: (b): the same width at ``MODEL_HOST_LAYERS`` layers in f32, TF32 off,
#: one step from the same state and batch on the card and on the host:
#: loss, grad norm and every leaf of params, m and v
TRAIN_HOST_BATCH, TRAIN_HOST_SEQ = 2, 256
TRAIN_HOST_TOL = dict(rtol=1e-4, atol=1e-4)
#: (c): the flash backward at tinyllama's attention shape, (B, S, Hq,
#: Hkv, D), f32, against autograd through the plain ``flash_forward`` on
#: the card, each gradient's max abs error over its largest entry; the
#: causal case, then a windowed and softcapped one
FLASH_BWD_SHAPE = (1, 2048, 32, 4, 64)
FLASH_BWD_CASES = (dict(causal=True),
                   dict(causal=True, window=512, softcap=50.0))
FLASH_BWD_TOL = 1e-4


def train_bounds(cfg, batch: int, seq: int) -> dict:
    """The least ms the card could take for one train step of (batch,
    seq) tokens of an attention trunk with remat, (ms, bound_by): every
    input read once and every output written once (f32 params, m and v
    read and written, the batch read: 24 bytes a param); operations at
    the bf16 rate, 2 a param a token for the trunk's products once
    forward, once recomputed and twice backward, and for the head's
    (never recomputed) three times; at the f32 rate the attention
    products the plain flash computes (every key block of its band, the
    masked ones too): QK and PV forward and recomputed, and five in the
    backward (the scores again, dV, dP, dQ, dK)."""
    from repro_torch.models import build_model, count_params
    from repro_torch.models.flash import _band_params
    from repro_torch.models.trunk import _block_kind, build_segments

    meta = build_model(cfg).param_meta()
    n_all, n_trunk = count_params(meta), count_params(meta["trunk"])
    tokens = batch * seq
    head = cfg.vocab_size * cfg.d_model
    bf16_ops = 2.0 * tokens * (4 * n_trunk + 3 * head)
    qc, kc = min(cfg.attn_q_chunk, seq), min(cfg.attn_kv_chunk, seq)
    f32_ops = 0.0
    for seg in build_segments(cfg):
        for kind in seg.kinds:
            if _block_kind(cfg, kind) != "attn":
                raise ValueError(f"{cfg.name}: train_bounds counts "
                                 f"attention trunks, not {kind}")
            window = cfg.sliding_window if kind == "local" else None
            nq, _, _, nband = _band_params(seq, seq, qc, kc, window, True)
            pairs = nq * qc * nband * kc
            f32_ops += (seg.count * 2.0 * batch * cfg.num_heads * pairs
                        * cfg.resolved_head_dim() * 9)
    step_bytes = 24 * n_all + 8 * tokens
    bf, f32 = PEAK_FLOPS["bfloat16"], PEAK_FLOPS["float32"]
    return {"step": bound_of(bf16_ops / bf + f32_ops / f32,
                             step_bytes / HBM_BYTES_PER_S)[:2],
            "bf16_ops": bf16_ops, "f32_ops": f32_ops,
            "step_bytes": step_bytes}


def train_settings(total_steps: int):
    """AdamW's defaults under ``warmup_cosine``, the warm-up as
    ``launch.train`` sets it."""
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.runtime import TrainSettings

    return TrainSettings(optimizer=AdamWConfig(
        schedule=warmup_cosine(max(total_steps // 20, 10), total_steps)))


def train_full(torch, dev, cfg) -> dict:
    """(a): ``cfg`` at full width and depth, one warm-up step then
    ``TRAIN_STEPS`` timed ones, each on the host clock to the device's
    end, then one more under the profiler.  Returns the report."""
    from repro_torch.data import DataPipeline, synthetic_lm_batch
    from repro_torch.models import build_model, count_params
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime import init_train_state, make_train_step

    B, S = TRAIN_BATCH, TRAIN_SEQ
    model = build_model(cfg)
    settings = train_settings(TRAIN_STEPS + 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), model, settings, device=dev)
    torch.cuda.synchronize()
    r = {"model": cfg.name, "batch": B, "seq": S,
         "params": count_params(model.param_meta()),
         "init_s": time.perf_counter() - t0,
         "bounds": train_bounds(cfg, B, S)}
    step_fn = make_train_step(model, settings)
    pipe = DataPipeline(
        lambda sd, st: synthetic_lm_batch(sd, st, B, S, cfg.vocab_size),
        seed=TRAIN_SEED, device=dev)
    r["losses"], r["grad_norms"], step_s = [], [], []
    try:
        for i in range(1 + TRAIN_STEPS):
            _, batch = next(pipe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            if i:
                step_s.append(time.perf_counter() - t0)
            else:
                r["first_step_s"] = time.perf_counter() - t0
                r["unchanged_leaves"] = sum(
                    torch.equal(a, b) for a, b in zip(
                        tree_leaves(state["params"]),
                        tree_leaves(new["params"])))
            state = new
            del new
            r["losses"].append(float(metrics["loss"]))
            r["grad_norms"].append(float(metrics["grad_norm"]))
        _, batch = next(pipe)
        _, r["busy_ms"], r["kernels"], r["top"], r["top_ops"] = profiled(
            torch, lambda: step_fn(state, batch), top=10)
    finally:
        pipe.close()
    del state
    step_s.sort()
    r["step_ms"] = step_s[len(step_s) // 2] * 1e3
    r["step_ms_all"] = [round(x * 1e3, 1) for x in step_s]
    r["tokens_per_s"] = B * S / (r["step_ms"] / 1e3)
    r["peak_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    r["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    return r


def train_host_check(torch, dev, cfg) -> dict:
    """(b): ``cfg`` at ``MODEL_HOST_LAYERS`` layers in f32 (TF32 off by
    the caller), one step of ``TRAIN_HOST_BATCH`` x ``TRAIN_HOST_SEQ``
    from the same state and batch on the card and on the host: the
    largest abs error of the loss, the grad norm and every leaf of the
    new params, m and v, and the worst excess over ``TRAIN_HOST_TOL``."""
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.runtime import init_train_state, make_train_step

    small = cfg.replace(num_layers=MODEL_HOST_LAYERS, dtype="float32")
    model = build_model(small)
    settings = train_settings(TRAIN_STEPS + 2)
    state = init_train_state(torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), model, settings, device=dev)
    host_state = tree_map(lambda t: t.cpu(), state)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_lm_batch(
        TRAIN_SEED, 0, TRAIN_HOST_BATCH, TRAIN_HOST_SEQ,
        cfg.vocab_size).items()}
    step_fn = make_train_step(model, settings)
    card, card_m = step_fn(state, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, host_m = step_fn(host_state, batch)
    out = {"host_s": time.perf_counter() - t0, "loss": float(host_m["loss"]),
           "max_abs_err": 0.0, "excess": -1.0, "worst": None}

    def hold(name, got, want):
        got, want = got.detach().cpu().double(), want.detach().double()
        err = float((got - want).abs().max())
        excess = float(((got - want).abs() - TRAIN_HOST_TOL["atol"]
                        - TRAIN_HOST_TOL["rtol"] * want.abs()).max())
        if excess > out["excess"]:
            out["excess"], out["worst"] = excess, name
        out["max_abs_err"] = max(out["max_abs_err"], err)

    for k in ("loss", "grad_norm"):
        hold(k, card_m[k], host_m[k])
    out["leaves"] = 0
    for part, got, want in (("params", card["params"], host["params"]),
                            ("m", card["opt"]["m"], host["opt"]["m"]),
                            ("v", card["opt"]["v"], host["opt"]["v"])):
        for (key, a), b in zip(flat_items(got), tree_leaves(want)):
            hold(f"{part}/{key}", a, b)
            out["leaves"] += 1
    return out


def flat_items(tree, prefix: str = ""):
    """``(path, leaf)`` of nested dicts, keys in sorted order (the order
    of ``tree_leaves``)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat_items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def flash_bwd_check(torch, dev) -> list:
    """(c): ``flash_attention``'s gradients (its autograd Function, the
    port's ``flash_backward``) against autograd through the plain
    ``flash_forward`` on the card, f32, at ``FLASH_BWD_SHAPE``, one row a
    case of ``FLASH_BWD_CASES``: each gradient's max abs error over its
    largest entry, and ms a forward and backward of each (CUDA events,
    3 calls)."""
    from repro_torch.models.flash import flash_attention, flash_forward

    B, S, Hq, Hkv, D = FLASH_BWD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v, dout = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D), \
        rnd(B, S, Hq, D)
    rows = []
    for kw in FLASH_BWD_CASES:
        def grads(fn, kw=kw):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(fn(*ts, **kw), ts, dout)

        def plain(*a, **k_):
            return flash_forward(*a, **k_)[0]

        got, want = grads(flash_attention), grads(plain)
        row = {"case": kw}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            row[name] = float((a - b).abs().max() / b.abs().max())
        row["ms"] = time_ms(torch, lambda: grads(flash_attention), iters=3,
                            warmup=1)
        row["autograd_ms"] = time_ms(torch, lambda: grads(plain), iters=3,
                                     warmup=1)
        rows.append(row)
        del got, want
    return rows


def phase_train(torch, dev) -> dict:
    """The zoo's training path, with the launch counters zeroed just
    before and read just after: (a) ``TRAIN_NAME`` at full width and
    depth (:func:`train_full`): fails on a non-finite loss or grad norm
    at any step, a step-0 loss more than ``TRAIN_LOSS_BAND`` from
    ln(vocab), a param leaf the warm-up step left unchanged, or a param
    count other than ``TRAIN_PARAMS``; logs step ms (median of the timed
    steps) and tokens/s beside :func:`train_bounds`, the profiled step's
    device busy ms and kernel launches, the device-memory peak and every
    step's loss.  (b) :func:`train_host_check` within ``TRAIN_HOST_TOL``.
    (c) :func:`flash_bwd_check` within ``FLASH_BWD_TOL``.  (d)
    ``repro_torch.bench.train_lm`` at its defaults (qwen3-4b at
    ``--reduce 6``, 200 steps of 8 x 256 through ``launch.train.train``,
    ``FaultTolerantRunner`` and ``CheckpointManager`` in a temporary
    directory): its last loss below its first, 0 recoveries.  The six
    kernels' launches over the phase must be 0: the zoo's training path
    keeps its own attention, norms and optimiser, as the reference's
    does.  Returns ``{kernel: launches}``."""
    import math

    from repro_torch.bench import train_lm
    from repro_torch.configs import get_config
    from repro_torch.device import full_f32
    from repro_torch.kernels import ops

    card = card_line()
    cfg = get_config(TRAIN_NAME)
    torch.cuda.synchronize()
    ops.reset_launches()
    failures = []
    t0 = time.perf_counter()
    r = train_full(torch, dev, cfg)
    r["seconds"] = time.perf_counter() - t0
    b = r["bounds"]
    log(f"  {cfg.name} on {card}: {r['params']:,} f32 params, train step "
        f"{r['batch']}x{r['seq']} {r['step_ms']:.1f} ms (median of "
        f"{TRAIN_STEPS}: {r['step_ms_all']}; the warm-up step "
        f"{r['first_step_s'] * 1e3:.1f} ms), {r['tokens_per_s']:.0f} "
        f"tokens/s; bound {b['step'][0]:.2f} ms by {b['step'][1]} "
        f"({b['bf16_ops']:.4g} bf16 and {b['f32_ops']:.4g} f32 operations, "
        f"{b['step_bytes'] / 1e9:.2f} GB); peak {r['peak_allocated_gb']:.2f} "
        f"GB allocated ({r['peak_reserved_gb']:.2f} reserved)")
    log(f"  a step under the profiler: device busy {r['busy_ms']:.2f} ms, "
        f"{r['kernels']} kernel launches; top kernels: "
        f"{'; '.join(r['top'])}; top ATen ops by their kernels' time: "
        f"{'; '.join(r['top_ops'])}")
    log(f"  losses by step: {[round(x, 4) for x in r['losses']]}; grad "
        f"norms: {[round(x, 4) for x in r['grad_norms']]}")
    ln_v = math.log(cfg.vocab_size)
    if r["params"] != TRAIN_PARAMS:
        failures.append(f"{cfg.name}: {r['params']} params, not "
                        f"{TRAIN_PARAMS}")
    if not all(map(math.isfinite, r["losses"] + r["grad_norms"])):
        failures.append(f"{cfg.name}: a non-finite loss or grad norm")
    if not abs(r["losses"][0] - ln_v) <= TRAIN_LOSS_BAND:
        failures.append(f"{cfg.name}: step-0 loss {r['losses'][0]:.4f} is "
                        f"more than {TRAIN_LOSS_BAND} from ln(vocab) "
                        f"{ln_v:.4f}")
    if r["unchanged_leaves"]:
        failures.append(f"{cfg.name}: the step left {r['unchanged_leaves']} "
                        f"param leaves unchanged")
    torch.cuda.empty_cache()

    with full_f32():
        h = train_host_check(torch, dev, cfg)
    torch.cuda.empty_cache()
    r["host_check"] = h
    log(f"  {cfg.name} f32 at {MODEL_HOST_LAYERS} layers, one step of "
        f"{TRAIN_HOST_BATCH}x{TRAIN_HOST_SEQ}, card vs host: max abs err "
        f"{h['max_abs_err']:.4g} over the loss, the grad norm and "
        f"{h['leaves']} leaves of params, m and v (worst excess over "
        f"{TRAIN_HOST_TOL}: {h['excess']:.4g} at {h['worst']}; host "
        f"{h['host_s']:.1f} s, loss {h['loss']:.4f})")
    if h["excess"] > 0:
        failures.append(f"{cfg.name} f32 train step: the card differs from "
                        f"the host by {h['max_abs_err']:.4g} "
                        f"({TRAIN_HOST_TOL}, at {h['worst']})")

    with full_f32():
        rows = flash_bwd_check(torch, dev)
    r["flash_backward"] = rows
    for row in rows:
        log(f"  flash backward {FLASH_BWD_SHAPE} f32 {row['case']}: dq "
            f"{row['dq']:.3g}, dk {row['dk']:.3g}, dv {row['dv']:.3g} of "
            f"each one's largest entry against autograd through "
            f"flash_forward; forward and backward {row['ms']:.2f} ms "
            f"(autograd {row['autograd_ms']:.2f} ms)")
        if max(row["dq"], row["dk"], row["dv"]) > FLASH_BWD_TOL:
            failures.append(f"flash backward {row['case']}: off autograd "
                            f"by more than {FLASH_BWD_TOL}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm = train_lm.run([])
    r["train_lm"] = {k: lm[k] for k in ("params", "first_loss", "last_loss",
                                        "final_step", "recoveries",
                                        "wall_s")}
    r["train_lm"]["seconds"] = time.perf_counter() - t0
    log(f"  train_lm (qwen3-4b --reduce 6, 200 steps of 8x256): "
        f"{json.dumps(r['train_lm'])}")
    if not lm["last_loss"] < lm["first_loss"] or lm["recoveries"]:
        failures.append(f"train_lm: loss {lm['first_loss']:.4f} -> "
                        f"{lm['last_loss']:.4f}, {lm['recoveries']} "
                        f"recoveries")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    r["launches"] = counts
    log("model training: " + json.dumps(r))
    if any(counts.values()):
        failures.append(f"the training path launched a kernel: {counts}")
    if failures:  # every part above is logged before the phase fails
        raise fail("; ".join(failures))
    return counts


#: phase 6k (a): data-parallel training at ``bench/train_lm``'s
#: configuration (qwen3-4b reduced 6 x, 8 x 256 tokens, lr 1e-3), 20
#: steps in f32 compute (TF32 off), over ``POD_RANKS`` gloo ranks sharing
#: the card at model axis 1 and 2 (meshes (4, 1) and (2, 2)), each held
#: to one rank's run of the same steps on the card; checkpoints only the
#: runner's step-0 anchor and its final save (each a gather of the whole
#: state through the host), for time
POD_ARCH = "qwen3-4b"
POD_TRAIN = dict(steps=20, batch=8, seq=256, reduce=6, lr=1e-3,
                 ckpt_every=0, dtype="float32", log_every=0)
POD_PARAMS = 24_511_266
POD_RANKS = 4
POD_MODEL_AXES = (1, 2)
POD_TOL = dict(rtol=1e-4, atol=1e-4)
POD_TIMEOUT = 300
#: phase 6k (b): the dry-run runs, (arch, shape, multi-pod), each a
#: subprocess, beside (a) and (c)
POD_DRYRUNS = (("qwen3-4b", "train_4k", False),
               ("qwen3-4b", "prefill_32k", False),
               ("qwen3-4b", "decode_32k", False),
               ("deepseek-v2-lite-16b", "train_4k", False),
               ("qwen3-4b", "train_4k", True))
#: the cells (b) must record without an error
POD_CELLS = {("qwen3-4b", "train_4k", "16x16"),
             ("qwen3-4b", "prefill_32k", "16x16"),
             ("qwen3-4b", "decode_32k", "16x16"),
             ("deepseek-v2-lite-16b", "train_4k", "16x16"),
             ("qwen3-4b", "train_4k", "2x16x16")}
#: phase 6k (c): the pod proxy's tuning iterations (the reference's)
POD_PROXY_ITERS = 12


def pod_train(torch, dev, work: Path) -> dict:
    """Phase 6k (a): ``launch.train.train`` over ``POD_RANKS`` ranks at
    each model axis (two groups at once, eight ranks sharing the card)
    against one rank on the card.  Returns the logged figures; failures
    are listed under ``failures``."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch.distributed.launch import spawn
    from repro_torch.launch.train import rank_train, train
    from repro_torch.models.params import tree_leaves

    out = {"failures": []}
    t0 = time.perf_counter()
    one = train(POD_ARCH, device=dev, ckpt_dir=str(work / "pod_one"),
                **POD_TRAIN)
    want = [x.cpu().numpy() for x in tree_leaves(one.pop("state")["params"])]
    out["one_rank"] = {"seconds": time.perf_counter() - t0,
                       "params": one["params"],
                       "step_ms": 1e3 * float(np.median(one["step_s"][1:])),
                       "peak_gb": one["peak_allocated_bytes"] / 1e9,
                       "losses": [round(x, 5) for x in one["losses"]]}
    log(f"  one rank: {json.dumps(out['one_rank'])}")
    if one["params"] != POD_PARAMS:
        out["failures"].append(f"{one['params']} params, not {POD_PARAMS}")
    torch.cuda.empty_cache()

    def group(axis):
        t0 = time.perf_counter()
        ranks = spawn(rank_train, POD_RANKS, POD_ARCH,
                      dict(POD_TRAIN, device="cuda", model_axis=axis,
                           ckpt_dir=str(work / f"pod_dp{axis}"),
                           profile_step=POD_TRAIN["steps"] - 1),
                      True, device_type="cuda", timeout_s=POD_TIMEOUT)
        return ranks, time.perf_counter() - t0

    # the meshes' groups run at once, each its own ranks sharing the card
    with ThreadPoolExecutor(len(POD_MODEL_AXES)) as pool:
        groups = dict(zip(POD_MODEL_AXES, pool.map(group, POD_MODEL_AXES)))
    for axis, (ranks, seconds) in groups.items():
        mesh = f"({POD_RANKS // axis}, {axis})"
        loss_err = max(float(np.max(np.abs(np.asarray(r["losses"])
                                           - np.asarray(one["losses"]))))
                       for r in ranks)
        got = ranks[0]["params_whole"]
        param_err = max(float(np.max(np.abs(g - w)))
                        for g, w in zip(got, want))
        bad = [r for r, x in enumerate(ranks) if not np.allclose(
            x["losses"], one["losses"], **POD_TOL)]
        if len(got) != len(want) or not all(
                np.allclose(g, w, **POD_TOL) for g, w in zip(got, want)):
            bad.append("params")
        row = {"mesh": mesh, "seconds": seconds,
               "loss_max_abs_err": loss_err,
               "param_max_abs_err": param_err,
               "step_ms": [1e3 * float(np.median(r["step_s"][1:-1]))
                           for r in ranks],
               "collective_bytes_a_step": ranks[0]["step_collective_bytes"],
               "peak_gb": [r["peak_allocated_bytes"] / 1e9 for r in ranks],
               "replicated_ops": ranks[0]["replicated_ops"]}
        out[f"mesh_{axis}"] = row
        log(f"  {POD_RANKS} ranks at mesh {mesh}: {json.dumps(row)}")
        if bad:
            out["failures"].append(
                f"mesh {mesh}: {bad} differ from one rank beyond {POD_TOL} "
                f"(losses {loss_err:.3g}, params {param_err:.3g})")
    return out


def pod_dryruns(work: Path) -> list:
    """Phase 6k (b): start every ``POD_DRYRUNS`` run as a subprocess (one
    rank of a fake world: no card, no memory); returns ``[(label, Popen,
    out path, log path, start)]``, ``start`` on the wall clock."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = []
    for arch, shape, multi in POD_DRYRUNS:
        label = f"{arch}_{shape}{'_multi_pod' if multi else ''}"
        out, logf = work / f"dry_{label}.json", work / f"dry_{label}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)] + (
                   ["--multi-pod"] if multi else [])
        with open(logf, "w") as f:
            proc = subprocess.Popen(cmd, env=env, stdout=f,
                                    stderr=subprocess.STDOUT)
        runs.append((label, proc, out, logf, time.time()))
    return runs


def phase_pod(torch, dev) -> dict:
    """Phase 6k, the dry run and data-parallel training.  (b)'s dry runs
    start first, in subprocesses beside (a) and (c).  (a)
    ``pod_train``, the two meshes' groups at once: each rank's losses and
    rank 0's gathered final params within ``POD_TOL`` of one rank's; logs
    the step ms, the collective bytes of a step, each rank's memory peak
    and the ops run replicated.  (b) the dry
    run of ``POD_CELLS`` on the
    production meshes: logs each record's flops and bytes a device,
    collective bytes by kind and the operands that moved the most, peak
    GB, ``fits_hbm``, the dominant term, ``useful_flops_fraction``, the
    torch that ran and the walls; fails on an error or a
    missing cell.  (c) ``bench/proxy_for_pod_model --arch qwen3-4b
    --substrate hopper --iters 12`` with the launch counters zeroed just
    before and read just after; fails if ``matmul`` never launched.  (d)
    the roofline section of ``bench/run`` over (b)'s records, both
    meshes.  Returns (c)'s ``{kernel: launches}``."""
    from repro_torch.bench import proxy_for_pod_model
    from repro_torch.bench import run as bench_run
    from repro_torch.kernels import ops

    failures = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as work:
        work = Path(work)
        runs = pod_dryruns(work)
        try:
            failures += pod_train(torch, dev, work)["failures"]
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            rc = proxy_for_pod_model.main(["--arch", POD_ARCH, "--substrate",
                                           "hopper", "--iters",
                                           str(POD_PROXY_ITERS)])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            log(f"  pod proxy: exit {rc}, {time.perf_counter() - t0:.1f} s, "
                f"launches {json.dumps(counts)}")
            if rc != 0 or not counts.get("matmul"):
                failures.append(f"pod proxy: exit {rc}, matmul launched "
                                f"{counts.get('matmul')} times")
        finally:
            records = []
            for label, proc, out, logf, start in runs:
                try:
                    rc = proc.wait(timeout=POD_TIMEOUT)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = "killed"
                log(f"  dry run {label}: exit {rc}, "
                    f"{logf.stat().st_mtime - start:.1f} s (its log's last "
                    f"write); its log's tail: "
                    f"{logf.read_text()[-1500:]!r}")
                if out.exists():
                    records += json.loads(out.read_text())
                if rc != 0:
                    failures.append(f"dry run {label} exited {rc}")

        seen = set()
        for r in records:
            if "error" in r:
                failures.append(f"dry run {r['arch']} x {r['shape']}: "
                                f"{r['error'][:200]}")
                continue
            if r.get("skipped"):
                log(f"  dry run {r['arch']} x {r['shape']}: skipped "
                    f"({r['skipped'][:60]})")
                continue
            seen.add((r["arch"], r["shape"], r["mesh"]))
            log(f"  dry run {r['arch']} x {r['shape']} on {r['mesh']} "
                f"({r['devices']} ranks): flops/device "
                f"{r['flops_per_device']:.4g}, bytes/device "
                f"{r['bytes_per_device']:.4g}, collective bytes "
                f"{json.dumps(r['collective_bytes'])}, peak "
                f"{r['peak_memory_bytes'] / 1e9:.2f} GB, fits_hbm "
                f"{r['fits_hbm']}, dominant {r['dominant']} (compute "
                f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
                f"collective {r['collective_s']:.4g} s), useful flops "
                f"{r['useful_flops_fraction']:.3f}; ops run whole "
                f"{json.dumps(r.get('replicated_ops'))}; torch "
                f"{r['torch']}; top collectives "
                f"{json.dumps(r['top_collectives'])}; build "
                f"{r['lower_s']} s, profiled dispatch {r['compile_s']} s")
        if POD_CELLS - seen:
            failures.append(f"dry run cells missing: {sorted(POD_CELLS - seen)}")

        path = work / "dryrun_pod.json"
        path.write_text(json.dumps(records))
        for mesh in ("16x16", "2x16x16"):
            if bench_run.roofline_section(str(path), mesh=mesh) != 0:
                failures.append(f"roofline section on {mesh} failed")
    if failures:  # every part above is logged before the phase fails
        raise fail("; ".join(failures))
    return counts


#: the population phase's lane counts: two, and the evaluator's
#: ``DEFAULT_EVAL_BATCH``, the most lanes one population call takes
LANES = (2, 32)
#: lane forms against the loop of their plain versions (sort exact)
LANE_TOL = dict(rtol=1e-3, atol=1e-3)
#: integer outputs a population lane may not share with its eval form:
#: argmin/argmax over distances whose batched f32 sums can round apart at
#: a near-tie (as ``check_substrates`` allows between substrates)
LANE_INT_FRACTION = 1e-3
#: tuner_bench's runs in the population phase, each failing the run on
#: any gate: single and sweep with ``--run`` on the kernels (the sweep
#: with one profiling thread and with the default, auto).  The priors
#: mode is not run: on the port's profile its gate does not hold at the
#: reference's setup (ROADMAP queue 3)
TUNER_BENCH_RUNS = (
    ("--run", "--substrate", "hopper"),
    ("--run", "--substrate", "hopper", "--sweep", "--workers", "1"),
    ("--run", "--substrate", "hopper", "--sweep"),
)


def lane_bound(kind: str, args, lanes: int, in_dims=None) -> tuple:
    """``bound`` of ``lanes`` lanes of one call: each lane's operations,
    and the bytes of each batched operand and of the outputs once a lane;
    an operand every lane shares (``in_dims`` None there) is read once."""
    ops, nbytes, peak = work(kind, args)
    shared = sum(a.numel() * a.element_size()
                 for a, d in zip(args, in_dims or [0] * len(args))
                 if d is None)
    return bound_of(lanes * ops / peak,
                    (lanes * (nbytes - shared) + shared) / HBM_BYTES_PER_S)


def lane_row(torch, kind: str, lanes: int, args, dims=None) -> dict:
    """One kernel op's vmapped form on ``lanes`` lanes built from the main
    path's inputs ``args``, in one launch, against a per-lane loop of its
    plain version, timed beside the loop and one library call on the same
    lanes.  Lane 0 is the recorded input and lane j a permutation of its
    elements drawn from seed j, so the lanes are independent: the check
    fails unless neighbouring lanes' plain results differ by more than
    the tolerance, and a lane that returned another lane's result would
    fail it."""
    from repro_torch.core.evaluator import no_vmap_fallback
    from repro_torch.kernels import bitonic_sort, ops, ref
    from repro_torch.uint32 import bits, full, reinterpret

    def lanes_of(t):
        flat = bits(t).reshape(-1)
        out = [flat]
        for j in range(1, lanes):
            g = torch.Generator(device=t.device).manual_seed(j)
            out.append(flat[torch.randperm(flat.numel(), generator=g,
                                           device=t.device)])
        return reinterpret(torch.stack(out), t.dtype).view(lanes, *t.shape)

    def vmapped(fn, *a, in_dims=0):
        with no_vmap_fallback():
            return torch.func.vmap(fn, in_dims=in_dims)(*a)

    row = {"kernel": kind, "lanes": lanes}
    if kind == "matmul":
        x, y = args
        xs = lanes_of(x)
        ys = lanes_of(y) if dims[1] == 0 else y
        row["in_dims"] = list(dims)
        call = lambda: vmapped(ops.matmul, xs, ys, in_dims=dims)  # noqa
        ylane = (lambda j: ys[j]) if dims[1] == 0 else (lambda j: ys)
        loop = lambda: [ref.matmul(xs[j], ylane(j))  # noqa: E731
                        for j in range(lanes)]
        yb = ys if dims[1] == 0 else ys.expand(lanes, *ys.shape)
        library = lambda: torch.bmm(xs, yb)  # noqa: E731
        one = (x, y)
    elif kind == "row_moments":
        (x,) = args
        xs = lanes_of(x)
        call = lambda: vmapped(ops.row_moments, xs)  # noqa: E731
        loop = lambda: [ref.row_moments(xs[j]) for j in range(lanes)]  # noqa
        library = lambda: torch.var_mean(xs, dim=-1, correction=0)  # noqa
        one = (x,)
    else:
        x, block = args
        xs = lanes_of(x)
        sentinel = bitonic_sort.SENTINELS[x.dtype]
        call = lambda: vmapped(  # noqa: E731
            lambda v: bitonic_sort.bitonic_sort_blocks(v, block=block), xs)
        loop = lambda: [ref.sort_blocks(xs[j], block, sentinel)  # noqa
                        for j in range(lanes)]
        n = x.shape[0]
        padded = torch.cat([xs, full((lanes, (-n) % block), sentinel,
                                     x.dtype, x.device)], 1)
        if x.dtype == torch.uint32:  # the order-preserving int32 image
            padded = padded.view(torch.int32) ^ -(1 << 31)
        library = lambda: torch.sort(padded.view(-1, block), dim=-1)  # noqa
        one = (x, block)
    row["shape"] = [list(a.shape) if hasattr(a, "shape") else a
                    for a in one]
    row["dtype"] = str(one[0].dtype).replace("torch.", "")
    torch.cuda.synchronize()
    before = ops.launch_counts()[kind]
    got = call()
    torch.cuda.synchronize()
    row["launches_a_call"] = ops.launch_counts()[kind] - before
    if row["launches_a_call"] != 1:
        raise fail(f"{kind} over {lanes} lanes took "
                   f"{row['launches_a_call']} launches, not one")
    want = [[w] if isinstance(w, torch.Tensor) else list(w)
            for w in loop()]
    err = 0.0
    for j in range(lanes):
        gj = [g[j] for g in got] if isinstance(got, tuple) else [got[j]]
        for g, w in zip(gj, want[j]):
            if kind == "bitonic_sort":
                if not torch.equal(g, w):
                    raise fail(f"bitonic_sort lane {j} of {lanes} differs "
                               f"from its plain version")
            else:
                err = max(err, (g.float() - w.float()).abs().max().item())
                torch.testing.assert_close(g.float(), w.float(), **LANE_TOL)
        if j and all(
                torch.equal(a, b) if kind == "bitonic_sort" else
                torch.allclose(a.float(), b.float(), **LANE_TOL)
                for a, b in zip(want[j], want[j - 1])):
            raise fail(f"{kind} lanes {j - 1} and {j} agree within the "
                       f"tolerance: the check cannot tell them apart")
    row["max_abs_err"] = err
    row["ms"] = time_ms(torch, call, 20)
    row["plain_ms"] = time_ms(torch, loop, 5, warmup=1)
    row["library_ms"] = time_ms(torch, library, 20)
    row["device_ms"] = device_ms(torch, call, 20)[0]
    row["bound_ms"], row["bound_by"], _ = lane_bound(
        kind, one, lanes, dims if kind == "matmul" else None)
    return row


def phase_population(torch, dev, pb, work: Path) -> dict:
    """The population form on the card.

    (a) each of the three main-path ops' vmapped forms at ``LANES`` lanes
    built from the inputs the tuned K-means proxy gives it (lane 0 the
    input, every other lane a seeded permutation of it; matmul with the
    lanes on x and y, the kernel's lane axis, and on x alone, folded into
    M), one launch a call, against a per-lane loop of its plain version,
    with the loop's and one library call's times.

    (b) ``population_runtime`` on a ``run=True`` engine over the impact
    batch of the tuned proxy (``tuner_bench.impact_batch``): classes,
    builds, modes and wall logged beside the batched engine's per-class
    walls for the same batch; then each class's chunk once more, counters
    zeroed: every lane against its candidate's eval form on the card, and
    each kernel launched as often as one lane of the class launches it.

    (c) ``tuner_bench`` as ``TUNER_BENCH_RUNS`` says, failing on any
    gate: single and sweep with ``--run --substrate hopper`` (the sweep
    with ``--workers 1`` and with the default, auto).  Returns
    ``{"lane_forms": rows, "population_launches": counts over (b)}``."""
    from repro_torch.bench import tuner_bench
    from repro_torch.core.evaluator import BatchEvaluator, _key_attr
    from repro_torch.kernels import ops

    # (a) -------------------------------------------------------------------
    rec = _Recorder(torch)
    with rec.mode:
        pb.build_eval_fn(dev)(0, pb.lifted_values(dev))
    rows = []
    for kind in MAIN_PATH_KERNELS:
        if kind not in rec.calls:
            raise fail(f"the tuned kmeans proxy gave {kind} no input")
        args = rec.calls[kind][1]
        args = tuple(args[:2]) if kind == "matmul" else (
            (args[0],) if kind == "row_moments" else tuple(args))
        for lanes in LANES:
            for dims in (((0, 0), (0, None)) if kind == "matmul"
                         else (None,)):
                r = lane_row(torch, kind, lanes, args, dims)
                log(f"lane form {kind} x{lanes}"
                    + (f" in_dims {dims}" if dims else "")
                    + f" at {r['shape']} {r['dtype']}: ms={r['ms']:.4f} "
                    f"device_ms={fmt_ms(r['device_ms'])} "
                    f"plain_ms={r['plain_ms']:.4f} (loop) library_ms="
                    f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                    f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3g}")
                rows.append(r)

    # (b) -------------------------------------------------------------------
    batch = tuner_bench.impact_batch(pb)
    engine = BatchEvaluator(run=True, device=dev)
    t0 = time.perf_counter()
    engine.evaluate_batch(batch)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    classes = {engine.cache.key_for(c): c for c in batch}
    walls = [engine.signature_of(c).wall_time for c in classes.values()]
    t0 = time.perf_counter()
    pop = engine.population_runtime(batch)
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    log(f"population: {pop['candidates']} candidates of the impact batch "
        f"in {pop['classes']} class(es), {pop['compiles']} build(s), wall "
        f"{pop['wall_time'] * 1e3:.4f} ms ({pop_s:.1f} s with builds and "
        f"captures); the batched engine: {len(classes)} shape classes, "
        f"per-class walls summing to {sum(walls) * 1e3:.4f} ms "
        f"({batched_s:.1f} s with profiles)")
    for key, mode in pop["modes"].items():
        log(f"  class {key}: {json.dumps(mode)}")
    lanes_only = {k: m for k, m in pop["modes"].items()
                  if m["mode"] != "vmap"}
    if lanes_only:
        raise fail(f"population classes ran lane by lane: "
                   f"{json.dumps(lanes_only)}")
    torch.cuda.synchronize()
    ops.reset_launches()
    totals = dict.fromkeys(MAIN_PATH_KERNELS, 0)
    lanes_of = {}
    for chunk in engine.population_chunks(batch):
        before = ops.launch_counts()
        out = chunk.runner(0)()
        torch.cuda.synchronize()
        mid = ops.launch_counts()
        chunk.entry.fn(0, chunk.vals[0], max_reps=chunk.caps)  # one lane
        torch.cuda.synchronize()
        after = ops.launch_counts()
        name = _key_attr(chunk.key)
        for k in MAIN_PATH_KERNELS:
            vm, one = mid[k] - before[k], after[k] - mid[k]
            if vm != one:
                raise fail(f"class {name}: {k} launched {vm} times over "
                           f"{len(chunk.members)} lanes, one lane {one}")
            totals[k] += vm
        for j, c in enumerate(chunk.members):
            want = c.build_eval_fn(dev)(0, c.lifted_values(dev))
            for nid, leaves in want.items():
                for leaf, w in leaves.items():
                    g = out[nid][leaf][j]
                    if w.dtype.is_floating_point:
                        torch.testing.assert_close(g, w, **LANE_TOL)
                    else:
                        frac = (g != w).float().mean().item()
                        if frac > LANE_INT_FRACTION:
                            raise fail(f"class {name} lane {j}: "
                                       f"{nid}.{leaf} differs on {frac:.2%}")
        lanes_of[name] = lanes_of.get(name, 0) + len(chunk.members)
    for name, n in lanes_of.items():
        log(f"  class {name}: {n} lanes equal their eval forms")
    log(f"population launches over one call a chunk: {json.dumps(totals)}")
    never = [k for k, v in totals.items() if v == 0]
    if never:
        raise fail(f"the population form never launched {never}")

    # (c) -------------------------------------------------------------------
    for mode in TUNER_BENCH_RUNS:
        out = work / "tuner_bench.json"
        t0 = time.perf_counter()
        rc = tuner_bench.main(["--device", str(dev), "--out", str(out),
                               *mode])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise fail(f"tuner_bench {' '.join(mode)} returned {rc}")
        doc = json.loads(out.read_text())
        if doc["mode"] == "single":
            detail = (f"serial_iter_s {doc['serial_iter_s']} batched_iter_s "
                      f"{doc['batched_iter_s']} population "
                      f"{json.dumps(doc['population'])} qualification "
                      f"{json.dumps(doc['qualification'])}")
        else:
            detail = (f"separate {json.dumps(doc['separate'])} shared "
                      f"wall_s {doc['shared']['wall_s']} compiles "
                      f"{doc['shared']['compiles']} cross_workload_hits "
                      f"{doc['shared']['cross_workload_hits']} "
                      f"compile_workers_max "
                      f"{doc['shared']['stats']['compile_workers_max']}")
        log(f"tuner_bench {' '.join(mode)}: {seconds:.1f} s, {detail}")
    return {"lane_forms": rows, "population_launches": totals}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="env,kernels,main,workloads,paper_repro,"
                            "case_studies,population,serve,scenarios,"
                            "stress,model,train,pod,bench",
                    help="comma list of env, kernels, main (main includes "
                         "the checks and main-path shapes), workloads (the "
                         "other four workloads), paper_repro (the sweep of "
                         "all five from BASE_P), case_studies (the paper's "
                         "§IV), population (the population form and "
                         "tuner_bench; needs main), serve (the proxy "
                         "server; needs paper_repro), scenarios (the "
                         "cluster scenarios on ranks sharing the card), "
                         "stress (the stress tier, the pipeline and the "
                         "elastic restore on ranks sharing the card), "
                         "model (the model zoo's serving path: qwen3-4b, "
                         "deepseek-v2-lite-16b, mamba2-780m, "
                         "recurrentgemma-9b and whisper-small at full "
                         "width and depth, prefill and decode), train "
                         "(the zoo's training path: tinyllama-1.1b at full "
                         "width and depth, the card against the host, the "
                         "flash backward, train_lm), pod (the dry run "
                         "on the production meshes, data-parallel "
                         "training on ranks sharing the card, the pod "
                         "proxy, the roofline table), bench "
                         "(needs "
                         "kernels)")
    opts = ap.parse_args(argv)
    phases = set(opts.phases.split(","))
    if "bench" in phases and "kernels" not in phases:
        ap.error("the bench phase reports the kernels phase's full-width "
                 "times: add kernels")
    if "population" in phases and "main" not in phases:
        ap.error("the population phase runs the main path's tuned proxy's "
                 "impact batch: add main")
    if "serve" in phases and "paper_repro" not in phases:
        ap.error("the serve phase serves the paper_repro phase's proxies "
                 "from its store: add paper_repro")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on a GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        free, total = torch.cuda.mem_get_info(dev)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s; device memory "
            f"allocated {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, "
            f"reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB, "
            f"free {free / 2**30:.2f} of {total / 2**30:.2f} GiB")
        return out

    timed("env", phase_env, torch, dev)  # always: every phase's set-up
    kernel_rows = (timed("kernels", phase_kernels, torch, dev)
                   if "kernels" in phases else [])
    entries, kmeans_pb = [], None
    if "main" in phases:
        entries, kmeans_pb = timed("main", phase_main_all, torch, dev)
    launches, path_rows = {}, []
    if "workloads" in phases:
        launches, path_rows = timed("workloads", phase_workloads, torch, dev)
    paper_launches, serve_launches, case_launches = {}, {}, {}
    population = {"lane_forms": [], "population_launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        work = Path(work)
        if "paper_repro" in phases:
            paper_launches, proxies = timed(
                "paper_repro", phase_paper_repro, torch, dev,
                str(work / "sweep_store"))
        if "case_studies" in phases:
            case_launches = timed("case_studies", phase_case_studies, torch,
                                  dev, work)
        if "population" in phases:
            population = timed("population", phase_population, torch, dev,
                               kmeans_pb, work)
        if "serve" in phases:
            serve_launches = timed("serve", phase_serve, torch, dev, work,
                                   proxies)
        scenario_launches = {}
        if "scenarios" in phases:
            scenario_launches = timed("scenarios", phase_scenarios, torch,
                                      dev, work)
        stress_launches = {}
        if "stress" in phases:
            stress_launches = timed("stress", phase_stress, torch, dev, work)
    model_launches = {}
    if "model" in phases:
        model_launches = timed("model", phase_model, torch, dev)
    train_launches = {}
    if "train" in phases:
        train_launches = timed("train", phase_train, torch, dev)
    pod_launches = {}
    if "pod" in phases:
        pod_launches = timed("pod", phase_pod, torch, dev)
    if "bench" in phases:
        entries += timed("bench", phase_bench, torch, dev, kernel_rows)
    for e in entries:  # the other workloads' paths, beside the main one
        e["workload_launches"] = {w: c[e["name"]]
                                  for w, c in launches.items()}
        e["paper_repro_launches"] = {w: c[e["name"]]
                                     for w, c in paper_launches.items()}
        e["serve_launches"] = serve_launches.get(e["name"])
        e["scenario_launches"] = scenario_launches.get(e["name"])
        e["stress_launches"] = stress_launches.get(e["name"])
        e["model_launches"] = model_launches.get(e["name"])
        e["train_launches"] = train_launches.get(e["name"])
        e["pod_launches"] = pod_launches.get(e["name"])
        e["case_studies_launches"] = {c: n[e["name"]]
                                      for c, n in case_launches.items()}
        e["population_launches"] = population["population_launches"].get(
            e["name"])
        e["lane_forms"] = [
            {k: r.get(k) for k in ("lanes", "in_dims", "shape", "dtype",
                                   "launches_a_call", "max_abs_err", "ms",
                                   "device_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")}
            for r in population["lane_forms"] if r["kernel"] == e["name"]]
        e["workload_shapes"] = [
            {k: r[k] for k in ("workload", "shape", "dtype", "max_abs_err",
                               "ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}
            for r in path_rows if r["kernel"] == e["name"]]
    log("kernels: " + ", ".join(f"{e['name']}={e['launches']}"
                                for e in entries))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
