"""Which collectives gloo runs on CUDA tensors, on this host.

The cluster scenarios run several ranks on one card with gloo between
them (NCCL refuses two ranks on one device).  For each collective the
scenarios' programs may issue, this starts its own group of two ranks on
the card and runs it once on a CUDA tensor: the five c10d collectives,
then the functional ones DTensor issues (``_c10d_functional``, each
waited on), alone and after the five plain ones in one group, then the
point-to-point exchanges a pipeline's ring shift may use (a blocking
``send``/``recv`` pair, and ``batch_isend_irecv``).  A line a
case: ``ok`` with the result rank 0 holds and whether it is right, the
error, or how the group ended (a crash).

Usage::

  PYTHONPATH=src python -m repro_torch.bench.gloo_collectives
"""
from __future__ import annotations

import sys

import torch
import torch.distributed as dist

PLAIN = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single", "broadcast")
FUNCTIONAL = ("funcol_all_reduce", "funcol_all_gather")
POINT_TO_POINT = ("send_recv", "batch_isend_irecv")


def _one(name: str):
    """Run collective ``name`` on rank-dependent CUDA inputs; returns
    (result as a list, the result every rank should hold)."""
    import torch.distributed._functional_collectives as funcol

    dev, r = torch.device("cuda"), dist.get_rank()
    if name == "all_reduce":
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        return t.tolist(), [2.0] * 4
    if name == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, torch.full((4,), float(r),
                                                    device=dev))
        return out.tolist(), [0.0] * 4 + [1.0] * 4
    if name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.ones(4, device=dev))
        return out.tolist(), [2.0, 2.0]
    if name == "all_to_all_single":
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, torch.arange(4.0, device=dev) + 10 * r)
        return out.tolist(), ([0.0, 1.0, 10.0, 11.0] if r == 0
                              else [2.0, 3.0, 12.0, 13.0])
    if name == "broadcast":
        t = torch.full((4,), float(r), device=dev)
        dist.broadcast(t, 0)
        return t.tolist(), [0.0] * 4
    if name == "funcol_all_reduce":
        out = funcol.all_reduce(torch.ones(4, device=dev), "sum",
                                dist.group.WORLD)
        return funcol.wait_tensor(out).tolist(), [2.0] * 4
    if name == "funcol_all_gather":
        out = funcol.all_gather_tensor(torch.full((2,), float(r), device=dev),
                                       0, dist.group.WORLD)
        return funcol.wait_tensor(out).tolist(), [0.0, 0.0, 1.0, 1.0]
    # each rank sends its own values to the other and keeps what it gets
    mine, other = torch.full((4,), float(r), device=dev), 1 - r
    got = torch.empty(4, device=dev)
    if name == "send_recv":  # rank 0 sends first, rank 1 receives first
        if r == 0:
            dist.send(mine, other)
            dist.recv(got, other)
        else:
            dist.recv(got, other)
            dist.send(mine, other)
        return got.tolist(), [float(other)] * 4
    if name == "batch_isend_irecv":
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, mine, other),
                 dist.P2POp(dist.irecv, got, other)]):
            work.wait()
        return got.tolist(), [float(other)] * 4
    raise ValueError(name)


def _rank(names):
    """Each of ``names`` in turn on this rank: (name, right, result)."""
    out = []
    for name in names:
        got, want = _one(name)
        out.append((name, got == want, got))
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    from repro_torch.distributed.launch import spawn

    if not torch.cuda.is_available():
        print("gloo_collectives: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, backend cpu:gloo,cuda:gloo, 2 ranks")
    cases = ([(n,) for n in PLAIN + FUNCTIONAL] + [PLAIN + FUNCTIONAL]
             + [(n,) for n in POINT_TO_POINT])
    failed = 0
    for names in cases:
        label = names[0] if len(names) == 1 else "the five, then functional"
        try:
            results = spawn(_rank, 2, names, device_type="cuda",
                            timeout_s=120)[0]
        except Exception as e:  # noqa: BLE001 — a crash is the finding
            failed += 1
            first = (str(e).strip().splitlines() or [""])[-1][:160]
            print(f"{label}: failed: {type(e).__name__}: {first}")
            continue
        for name, right, got in results:
            failed += not right
            print(f"{label}: {name} ok, {'right' if right else 'WRONG'} "
                  f"{got}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
