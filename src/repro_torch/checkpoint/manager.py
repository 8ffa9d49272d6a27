"""Sharded checkpointing: atomic, async, elastic (port of
``repro/checkpoint/manager.py``).

* **atomic** — a checkpoint is written to ``step_<N>.tmp`` and
  ``os.rename``d into place only after every leaf + manifest is fsynced;
  a crash mid-save never corrupts the latest checkpoint.
* **async** — ``save(..., blocking=False)`` snapshots the tensors to host
  memory on the caller's thread, then writes on a worker thread;
  training continues.
* **elastic restore** — leaves are stored whole (a DTensor is gathered
  with ``full_tensor()`` before it is written); restore places each leaf
  onto whatever ``DeviceMesh`` the *new* job uses, so a state saved under
  dp4 restores onto dp2 or onto one rank.
* **rolling window** — keeps the last ``keep`` checkpoints plus any
  explicitly pinned steps.

The on-disk form is the reference's: one ``.npy`` a leaf, numbered in
the reference's leaf order (dict keys sorted, ``None`` no leaf), and a
``manifest.json`` whose leaves carry ``key`` (the path, ``/``-joined),
``file``, ``shape`` and ``dtype``.  A bf16 leaf is its raw 16 bits in a
2-byte void ``.npy`` (``<V2``, manifest dtype ``"bfloat16"``), as
``np.save`` writes a JAX bf16 array, so a checkpoint written by either
package restores in the other.

Gathering a DTensor is a collective: every rank of its mesh saves the
same steps in the same order, and the gather runs on the caller's
thread, never the writer's.  Each rank writes the directory it was
given.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten_with_path, tree_unflatten

from repro_torch.core.store import atomic_write_text
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import whole

_STEP_RE = re.compile(r"^step_(\d+)$")
#: the manifest dtype and ``.npy`` descr of a bf16 leaf, the reference's
BF16 = "bfloat16"
_BF16_DESCR = "<V2"


def _path_str(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return str(p.idx)
    return str(p)


def _raw(p):
    return p.key if hasattr(p, "key") else getattr(p, "idx", str(p))


def _flatten_with_paths(tree) -> List[Tuple[str, Tuple, Any]]:
    """``(key, path, leaf)`` in the reference's leaf order: dict keys
    sorted, a ``None`` no leaf (``torch.utils._pytree`` keeps dicts in
    insertion order and counts ``None`` as a leaf)."""
    flat, _ = tree_flatten_with_path(tree)
    flat = sorted((pl for pl in flat if pl[1] is not None),
                  key=lambda pl: tuple(_raw(p) for p in pl[0]))
    return [("/".join(_path_str(p) for p in path), path, leaf)
            for path, leaf in flat]


def _treedef_str(tree) -> str:
    """``str`` of the reference's treedef for dicts, lists and tuples."""
    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _at(tree, path):
    """The subtree of ``tree`` at a pytree path."""
    for p in path:
        tree = tree[_raw(p)]
    return tree


#: (unsigned torch dtype, its signed view, the numpy dtypes of both):
#: an unsigned leaf crosses to numpy as its signed view's bits
_UNSIGNED = ((torch.uint16, torch.int16, np.uint16, np.int16),
             (torch.uint32, torch.int32, np.uint32, np.int32),
             (torch.uint64, torch.int64, np.uint64, np.int64))


def _to_numpy(t) -> np.ndarray:
    """A host snapshot of a leaf as numpy; a bf16 leaf as its raw bits
    (int16: numpy has no bf16)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = whole(t).cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy()
    for unsigned, signed, np_unsigned, _ in _UNSIGNED:
        if t.dtype == unsigned:
            return t.view(signed).numpy().view(np_unsigned).copy()
    return t.numpy().copy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    for unsigned, _, np_unsigned, np_signed in _UNSIGNED:
        if arr.dtype == np_unsigned:
            return torch.from_numpy(arr.view(np_signed)).view(unsigned)
    return torch.from_numpy(arr)


def _save_npy(f, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, with a bf16 leaf's header the reference's ``<V2``."""
    if dtype != BF16:
        np.save(f, arr)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
    f.write(np.ascontiguousarray(arr).tobytes())


@dataclass
class CheckpointInfo:
    step: int
    path: str
    time: float


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- enumeration --------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = True,
             pinned: bool = False) -> None:
        """Write ``state`` (dicts, lists and tuples of tensors) as
        checkpoint ``step``."""
        self.wait()  # one in-flight async save at a time
        # snapshot to host memory NOW, on this thread (updated buffers
        # must not be read later by the worker thread, and gathering a
        # DTensor is a collective)
        flat = []
        for key, _, v in _flatten_with_paths(state):
            dtype = (BF16 if isinstance(v, torch.Tensor)
                     and v.dtype == torch.bfloat16 else None)
            arr = _to_numpy(v)
            flat.append((key, arr, dtype or str(arr.dtype)))
        treedef = _treedef_str(state)

        def write():
            final = os.path.join(self.directory, f"step_{step}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "time": time.time(), "pinned": pinned,
                        "leaves": [], "treedef": treedef}
            for i, (key, arr, dtype) in enumerate(flat):
                fname = f"leaf_{i:05d}.npy"
                with open(os.path.join(tmp, fname), "wb") as f:
                    _save_npy(f, arr, dtype)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"].append({
                    "key": key, "file": fname,
                    "shape": list(arr.shape), "dtype": dtype})
            mpath = os.path.join(tmp, "manifest.json")
            atomic_write_text(mpath, json.dumps(manifest))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # the atomic commit point
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=self._guard(write),
                                            daemon=True)
            self._thread.start()

    def _guard(self, fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — captured for
                # re-raise in wait(): the async writer thread must
                # surface *any* failure, not die silently
                self._error = e
        return run

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = self.all_steps()
        pinned = set()
        for s in steps:
            try:
                with open(os.path.join(self.directory, f"step_{s}",
                                       "manifest.json")) as f:
                    if json.load(f).get("pinned"):
                        pinned.add(s)
            except Exception:  # noqa: BLE001 — unreadable/corrupt
                # manifest: treat the step as unpinned and eligible
                # for the rolling-window GC
                pass
        drop = [s for s in steps if s not in pinned][:-self.keep] \
            if self.keep else []
        for s in drop:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None,
                device: DeviceLike = None) -> Tuple[int, Any]:
        """Restore into the structure of ``like`` (a pytree of tensors, or
        of anything with ``shape`` and ``dtype``): each leaf takes its
        prototype's dtype and device.  A prototype with no data (a meta
        tensor, or a ``shape``/``dtype`` record) restores onto ``device``
        (``None`` is ``cuda``, as everywhere in the port).

        ``shardings`` (the same structure, a ``(DeviceMesh, placements)``
        tuple or ``None`` a leaf) places each leaf onto the *current*
        mesh with ``distribute_tensor`` — the elastic-restart path.  Every
        rank read the whole leaf, so each keeps its own slice and nothing
        moves between ranks; the mesh's ranks call this.  A DTensor
        prototype without a sharding is placed as the prototype is."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        by_key = {e["key"]: e for e in manifest["leaves"]}
        flat, spec = tree_flatten_with_path(like)
        leaves = []
        for path, proto in flat:
            if proto is None:
                leaves.append(None)
                continue
            key = "/".join(_path_str(p) for p in path)
            e = by_key.get(key)
            if e is None:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            arr = np.load(os.path.join(d, e["file"]))
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != "
                    f"{tuple(proto.shape)}")
            x = _from_numpy(arr, e["dtype"]).to(proto.dtype)
            sh = _at(shardings, path) if shardings is not None else None
            if sh is None and isinstance(proto, DTensor):
                sh = (proto.device_mesh, proto.placements)
            if sh is not None:
                mesh, placements = sh
                x = distribute_tensor(x, mesh, placements, src_data_rank=None)
            elif isinstance(proto, torch.Tensor) and not proto.is_meta:
                x = x.to(proto.device)
            else:
                x = x.to(resolve_device(device))
            leaves.append(x)
        return step, tree_unflatten(leaves, spec)
