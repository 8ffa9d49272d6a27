"""Prefetching data pipeline (port of ``repro/data/pipeline.py``).

Deterministic by step: batch N is a pure function of (seed, N), so a
restart (or an elastic re-shard onto another mesh) reproduces the exact
token stream, the property checkpoint/restart correctness depends on.
:func:`synthetic_lm_batch` is the reference's numpy stream, so both
packages see the same tokens bit for bit.

A background thread keeps ``prefetch`` batches ahead, each as pinned
host tensors (on a host with CUDA); :meth:`DataPipeline.__next__` copies
a batch to ``device`` on the consumer's current stream with
``non_blocking=True``.  That is the simplest correct form: the copy is
ordered before every later kernel on that stream, so the step that
reads it needs no event, while a pinned source lets it overlap the host
work that follows (a copy made by the worker on a stream of its own
would need an event the consumer waits on).  Under a port mesh,
``shardings`` (a tree of placements, as ``named_sharding`` gives them)
places each tensor with ``distributed.sharding.place``: every rank holds
the whole host batch and keeps its own slice.

A producer error is parked and re-raised on the consumer's next
``__next__``.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import current_mesh, place
from repro_torch.models.params import tree_map


def synthetic_lm_batch(seed: int, step: int, batch: int, seq: int,
                       vocab: int) -> Dict[str, np.ndarray]:
    """Deterministic LM batch: shifted-window token stream + labels."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DataPipeline:
    def __init__(self, make_batch: Callable[[int, int], Any], *,
                 shardings: Any = None, seed: int = 0, prefetch: int = 2,
                 start_step: int = 0, device: DeviceLike = None):
        self.make_batch = make_batch
        self.shardings = shardings
        self.seed = seed
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.mesh = current_mesh()  # the constructing thread's, if any
        self._pin = self.device.type == "cuda"
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _host(self, host_batch):
        """numpy arrays -> host tensors (pinned for a CUDA device)."""
        def one(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.pin_memory() if self._pin else t
        return tree_map(one, host_batch)

    def _put_device(self, batch):
        """Host tensors -> ``device``, on the caller's current stream."""
        batch = tree_map(
            lambda t: t.to(self.device, non_blocking=self._pin), batch)
        if self.shardings is None or self.mesh is None:
            return batch
        return tree_map(lambda t, pl: place(t, self.mesh, pl),
                        batch, self.shardings)

    def _worker(self):
        step = self._step
        try:
            while not self._stop.is_set():
                batch = self._host(self.make_batch(self.seed, step))
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        except BaseException as e:  # noqa: BLE001 — producer thread:
            # the error is parked and re-raised on the consumer's
            # next __next__(); the sentinel unblocks a waiting get()
            self._error = e
            self._q.put((-1, None))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if self._error is not None:
            raise self._error
        return step, self._put_device(batch)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
