"""Per-device dot flops of one reduced dry-run cell, op by op, in both
packages: the port's by ATen op and operand shapes
(``repro_torch.core.signature._dot_flops`` wrapped, with flash
attention's loops profiled at every call rather than once a shape), the
reference's by HLO ``dot`` instruction times the trip counts of the
loops around it (``repro.core.signature``'s own computation split and
call graph, on the text of the program ``run_cell`` compiled over a
plain ``Mesh`` of host devices, in a subprocess as
``tests/test_torch_dryrun.py`` runs it).  Each side's rows sum to its
record's ``dot_flops``.

Usage::

  PYTHONPATH=src python tests/torch_dot_breakdown.py \\
      --arch deepseek-v2-lite-16b --mesh 4x2 --reduce 8 \\
      --cell train,256,8,train [--top 40]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

REF_PROG = r"""
import json, re, sys
from collections import defaultdict
import repro.launch.dryrun as D
import repro.core.signature as S
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.launch.train import reduce_config

dshape, arch, factor, name, seq, batch, kind = json.loads(sys.argv[1])
texts, sigs = [], []
orig = D.signature_from_compiled
D.signature_from_compiled = lambda c: (
    texts.append(c.as_text()) or sigs.append(orig(c)) or sigs[-1])
n = int(np.prod(dshape))
mesh = Mesh(np.array(jax.devices()[:n]).reshape(dshape), ("data", "model"))
D.make_production_mesh = lambda multi_pod=False: mesh
cfg = reduce_config(get_config(arch), factor)
D.get_config = lambda a: cfg
D.SHAPES_BY_NAME = {name: ShapeCell(name, seq, batch, kind)}
D.run_cell(arch, name, False, verbose=False)
comps = S._split_computations(texts[-1])
entry = [k for k, v in comps.items()
         if k != "__entry__" and v is comps.get("__entry__")][0]
local = {k: S._local_stats(v) for k, v in comps.items() if k != "__entry__"}
mult = defaultdict(float)

def walk(c, m, depth=0):
    if c not in local or depth > 64:
        return
    mult[c] += m
    for callee, _ in local[c].calls:
        walk(callee, m, depth + 1)
    for body, cond, trip in local[c].while_conds:
        t = trip or S._trip_count(comps.get(cond, []))
        walk(body, m * t, depth + 1)
        walk(cond, m * t, depth + 1)

walk(entry, 1.0)
rows, calls = defaultdict(float), defaultdict(float)
for c, lines in comps.items():
    if c == "__entry__" or not mult.get(c):
        continue
    sym = {}
    for ln in lines:
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = (\S+) ", ln)
        if m:
            sym[m.group(1)] = m.group(2)
    rest = [ln for ln in lines if not re.search(r" dot\(", ln)]
    for ln in lines:
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = (\S+) dot\((.*)", ln)
        if not m:
            continue
        a, b = re.findall(r"%([\w.\-]+)", m.group(3))[:2]
        key = re.sub(r"\{[^}]*\}", "", f"dot {sym.get(a, '?')} x "
                     f"{sym.get(b, '?')} -> {m.group(2)}")
        rows[key] += S._local_stats(rest + [ln]).dot_flops * mult[c]
        calls[key] += mult[c]
print("JSON::" + json.dumps({"dot_flops": sigs[-1].dot_flops,
                             "rows": {k: [v, calls[k]]
                                      for k, v in rows.items()}}))
"""


def reference_rows(cell) -> dict:
    """The reference's ``{"dot_flops", "rows": {op: [flops, calls]}}``."""
    r = subprocess.run([sys.executable, "-c", REF_PROG, json.dumps(cell)],
                       capture_output=True, text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "JAX_PLATFORMS": "cpu"}, cwd=ROOT)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-3000:])
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON::")][0]
    return json.loads(line[len("JSON::"):])


def port_rows(cell) -> dict:
    """The port's ``{"dot_flops", "rows": {op: [flops, calls]}}``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import signature
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import reduce_config

    dshape, arch, factor, name, seq, batch, kind = cell
    rows, calls = defaultdict(float), defaultdict(int)
    dot = signature._dot_flops

    def counted(func, args, kwargs, out):
        f = dot(func, args, kwargs, out)
        if f:
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            key = (f"{func.overloadpacket.__name__} "
                   f"{' x '.join(map(str, shapes))} -> {tuple(out.shape)}")
            rows[key] += f
            calls[key] += 1
        return f

    signature._dot_flops, memo = counted, dryrun.MEMO
    dryrun.MEMO = ()
    try:
        cfg = reduce_config(get_config(arch), factor)
        with dryrun.fake_mesh(tuple(dshape), ("data", "model")) as mesh:
            rec = dryrun.cell_record(arch, name, cfg,
                                     ShapeCell(name, seq, batch, kind), mesh,
                                     verbose=False)
    finally:
        signature._dot_flops, dryrun.MEMO = dot, memo
    return {"dot_flops": rec["dot_flops"],
            "rows": {k: [v, calls[k]] for k, v in rows.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--mesh", default="4x2")
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--cell", default="train,256,8,train",
                    help="name,seq,batch,kind")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    name, seq, batch, kind = args.cell.split(",")
    cell = [[int(x) for x in args.mesh.split("x")], args.arch, args.reduce,
            name, int(seq), int(batch), kind]
    sides = {"reference": reference_rows(cell), "port": port_rows(cell)}
    for side, doc in sides.items():
        total = sum(v for v, _ in doc["rows"].values())
        print(f"{side}: dot_flops {doc['dot_flops']:.6g}, rows sum "
              f"{total:.6g}")
        for k, (v, n) in sorted(doc["rows"].items(),
                                key=lambda kv: -kv[1][0])[:args.top]:
            print(f"  {v:12.4e}  x{n:<5g} {k}")
    ref, port = sides["reference"]["dot_flops"], sides["port"]["dot_flops"]
    print(f"port / reference: {port / ref:.6f}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    raise SystemExit(main())
