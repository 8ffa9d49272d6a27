"""Copies of a kernel source, each built into its own library and timed:
the shared part of ``flash_tiles`` and ``split_tiles``.

A copy differs from the tree's source in constant lines of one
namespace: :func:`set_constants` rewrites them, and refuses a name the
namespace lacks or has twice.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict

import torch

from repro_torch.core.store import atomic_write_text
from repro_torch.kernels import _build


def namespace_parts(src: str, name: str) -> tuple:
    """(before, body, after) of ``namespace name { ... }  // namespace
    name`` in ``src``; the body between the two lines."""
    head, rest = src.split(f"namespace {name} {{", 1)
    body, tail = rest.split(f"}}  // namespace {name}", 1)
    return head, body, tail


def set_constants(src: str, namespace: str, prefix: str,
                  rewrite: Dict[str, Callable[[str], str]]) -> str:
    """``src`` with the right-hand side of each line matching the regular
    expression ``prefix.format(name=name)``, then ``rhs;...``, in the
    namespace replaced by ``rewrite[name](rhs)``; refuses a name whose
    line the namespace lacks or has twice."""
    head, body, tail = namespace_parts(src, namespace)
    for name, fn in rewrite.items():
        pattern = re.compile(
            rf"^({prefix.format(name=name)})([^;]*)(;.*)$", re.M)
        if len(pattern.findall(body)) != 1:
            raise ValueError(f"{namespace} lacks its {name} line, or has it "
                             f"twice")
        body = pattern.sub(lambda m: m.group(1) + fn(m.group(2))
                           + m.group(3), body)
    return (f"{head}namespace {namespace} {{{body}}}  // namespace "
            f"{namespace}{tail}")


def registers(report: str, kernel: str) -> list:
    """ptxas's lines for the kernels whose mangled name holds
    ``kernel``: name, registers, spills (ptxas prints a function's spill
    line before its register line)."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line and name:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and name and kernel in name:
                out.append({"kernel": name, "registers": int(m.group(1)),
                            "spill": spill})
                name = None
    return out


def build_copies(out_dir: Path, sources: Dict[str, str], symbol: str,
                 kernel: str) -> Dict[str, Callable]:
    """Compile each copy (one nvcc each, all started together) and load
    its entry point ``symbol``; print each copy's ptxas lines for the
    kernels named ``kernel``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        atomic_write_text(str(cu), text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), str(cu), "-o", str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{report}")
        print(json.dumps({"variant": name,
                          "ptxas": registers(report, kernel)}), flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"{name}.so")), symbol)
        fn.argtypes = _build.SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_ms(fn, iters: int) -> float:
    """Mean ms a call over ``iters`` back-to-back calls (CUDA events)."""
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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
