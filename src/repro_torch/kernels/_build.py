"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` (all started together)
for ``sm_90a`` and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``kernels/_build/<hash>/``, keyed by a hash of the sources and flags, so
an unchanged checkout builds once and a changed source rebuilds.  Nothing
is built at import: :func:`library` builds at first use, on a host with
``nvcc``.

:func:`define_op` registers each kernel as an op of the ``repro_torch``
namespace with ``torch.library.Library``: one Python function, the
wrapper, is the op's kernel for the CPU and the CUDA dispatch keys;
:func:`define_vmap` gives an op its batching rule for ``torch.func.vmap``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("matmul.cu", "row_moments.cu", "bitonic_sort.cu", "rmsnorm.cu",
           "flash_attention.cu", "moe_dispatch.cu")
HEADERS = ("common.cuh", "wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_kernels.so"

#: torch dtype -> the ``ReproDtype`` code of ``csrc/common.cuh``
DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.float32: 0, torch.bfloat16: 1, torch.uint32: 2, torch.int32: 3,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry points: name -> argtypes (every one returns a CUDA status)
SIGNATURES = {
    "repro_matmul_lanes": [_I, _I, _P, _P, _P, _L, _L, _L, _L, _L, _L, _L,
                           _P],
    "repro_row_moments": [_I, _P, _P, _P, _P, _L, _L, _I, _P],
    "repro_bitonic_tile": [_I, _P, _P, _L, _L, _I, _I, _I, _I, _P],
    "repro_bitonic_global": [_I, _P, _L, _I, _I, _I, _I, _P],
    "repro_rmsnorm": [_I, _I, _P, _P, _P, _L, _L, _F, _P],
    "repro_flash_attention": [_I, _P, _P, _P, _P, _L, _L, _L, _L, _I, _F,
                              _I, _P],
    "repro_moe_dispatch": [_I, _I, _P, _P, _P, _L, _L, _L, _L, _P],
}

#: the ``repro_torch`` op namespace, owned by this module
_LIB = torch.library.Library("repro_torch", "DEF")

#: what the last load did: whether it compiled, and the library's path
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # reprolint: ignore[trace-purity] — finds nvcc for the one-time build
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "repro_torch's kernels")


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel, link, and return ptxas's report."""
    nvcc = _nvcc()
    work = out_dir / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs: List[subprocess.Popen] = []
    objects: List[str] = []
    for name in SOURCES:
        obj = str(work / (name + ".o"))
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = []
    failed = []
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        reports.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(reports))
    tmp_lib = work / LIB_NAME
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *objects],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_lib, out_dir / LIB_NAME)  # atomic: readers see all or none
    shutil.rmtree(work, ignore_errors=True)
    report = "\n".join(reports)
    from repro_torch.core.store import atomic_write_text

    atomic_write_text(str(out_dir / "ptxas.txt"), report)
    return report


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use: once a process,
    at the first launch, in a ``kernels.load`` span of the process's
    default telemetry hub (``built``: whether this call compiled it)."""
    # kernels/ imports nothing of repro_torch.runtime at module level
    from repro_torch.runtime.telemetry import get_default

    with get_default().span("kernels.load") as sp:
        out_dir = BUILD_ROOT / source_digest()
        lib_path = out_dir / LIB_NAME
        compiled = not lib_path.exists()
        sp.set(built=compiled)
        if compiled:
            out_dir.mkdir(parents=True, exist_ok=True)
            _compile(out_dir)
        BUILD_INFO.update(compiled=compiled, path=str(lib_path))
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return getattr(library(), name)


def call(name: str, *args) -> None:
    """Call one C entry point and raise if it reports a CUDA error."""
    status = _entry(name)(*args)
    if status != 0:
        what = ("unsupported dtype code or size" if status < 0
                else library().repro_error_string(status).decode())
        raise RuntimeError(f"{name}: launch failed ({status}): {what}")


def define_op(schema: str, impl: Callable,
              meta: Optional[Callable] = None) -> None:
    """Define ``repro_torch::<schema>`` with ``impl`` as its kernel on the
    CPU and CUDA dispatch keys (``torch.ops.repro_torch.<name>``).

    A ``Library`` op costs the dispatcher a few microseconds a call, a
    ``torch.library.custom_op`` several times that (timed by
    ``repro_torch.bench.thresholds``).  ``impl`` checks its inputs, takes
    the plain version for CPU tensors and launches its kernel for CUDA
    ones.  ``meta`` gives the op's outputs on meta tensors (their shapes
    and dtypes, no data): DTensor places an op by running it there."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, impl, key)
    if meta is not None:
        _LIB.impl(name, meta, "Meta")


def define_vmap(name: str, rule: Callable) -> None:
    """Register ``rule`` as the batching rule of ``repro_torch::<name>``
    (``torch.library.register_vmap`` on this module's ``Library``), so
    ``torch.func.vmap`` runs the op once on all lanes instead of
    functorch's fallback, which calls it once a lane."""
    torch.library.register_vmap(f"repro_torch::{name}", rule, lib=_LIB)


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper: Callable, form: str = None) -> None:
    """Add one to ``wrapper.launches`` (and to ``wrapper.forms[form]``)
    under a lock: the evaluator's compile workers launch kernels from
    several threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if form is not None:
            wrapper.forms[form] += 1


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer value:
    the raw handle, without the ``torch.cuda.Stream`` object
    ``torch.cuda.current_stream`` would build."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def dtype_code(t: torch.Tensor, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"dtype {t.dtype} not supported (want one of "
                        f"{sorted(str(d) for d in allowed)})")
    return DTYPE_CODES[t.dtype]
