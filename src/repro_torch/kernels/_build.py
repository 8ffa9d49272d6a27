"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` (all started together)
for ``sm_90a`` and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``kernels/_build/<hash>/``, keyed by a hash of the sources and flags, so
an unchanged checkout builds once and a changed source rebuilds.  Nothing
is built at import: :func:`library` builds at first use, on a host with
``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("matmul.cu", "row_moments.cu", "bitonic_sort.cu")
HEADERS = ("common.cuh",)
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

#: C entry points: name -> argtypes (every one returns a CUDA status)
SIGNATURES = {
    "repro_matmul": [_I, _P, _P, _P, _L, _L, _L, _P],
    "repro_row_moments": [_I, _P, _P, _P, _P, _L, _L, _I, _P],
    "repro_bitonic_tile": [_I, _P, _P, _L, _L, _I, _I, _I, _I, _P],
    "repro_bitonic_global": [_I, _P, _L, _I, _I, _I, _P],
}

#: what the last build did (seconds, whether it compiled, ptxas report)
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
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
    (out_dir / "ptxas.txt").write_text(report)
    return report


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    out_dir = BUILD_ROOT / source_digest()
    lib_path = out_dir / LIB_NAME
    t0 = time.perf_counter()
    compiled = not lib_path.exists()
    if compiled:
        out_dir.mkdir(parents=True, exist_ok=True)
        _compile(out_dir)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, compiled=compiled,
                      path=str(lib_path))
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, *args) -> None:
    """Call one C entry point and raise if it reports a CUDA error."""
    lib = library()
    status = getattr(lib, name)(*args)
    if status != 0:
        what = ("unsupported dtype code" if status < 0
                else lib.repro_error_string(status).decode())
        raise RuntimeError(f"{name}: launch failed ({status}): {what}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"dtype {t.dtype} not supported (want one of "
                        f"{sorted(str(d) for d in allowed)})")
    return DTYPE_CODES[t.dtype]
