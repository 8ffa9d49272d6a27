"""Persistent on-disk proxy/eval-form store — warm starts across
processes (port of ``repro/core/store.py``).

Signature entries and tuned :class:`~repro_torch.core.generator.ProxyReport`
artifacts live on disk, so a fresh process replaying an already-stored
workload profiles no eval form again (**zero compiles**, the port's
compile being one profiled dispatch run).

The key is the hazard.  A persisted signature carries the wall time the
device measured, and the rate metrics derived from it; a profile's byte
counts depend on the torch build's ATen decompositions.  So the store
key is the evaluator's in-memory key (``ProxyBenchmark.shape_signature``,
which carries each node's structural P key, substrate included) followed
by a **device key** (:func:`device_key`: device type, card name, compute
capability, torch version, CUDA version), the counterpart of the
reference's mesh key.  An entry written by a CPU session, on another
card or under another torch, is a miss; so is an entry the JAX
package's store wrote in the same directory (its key has no device
component, so its digest differs).  The canonical on-disk form of a key
is ``repr()`` of that tuple, digested with SHA-256 for the file name;
the full repr is stored in the entry header and re-checked at load, so a
digest collision degrades to a miss, never to wrong metrics.

Durability policy:

* **atomic write-then-rename** — entries are written to a unique temp
  file, flushed + fsynced, then ``os.replace``d into place.  Concurrent
  writers on the same key each commit a complete entry; the last rename
  wins and readers only ever observe whole files.
* **versioned headers + checksums** — every entry records
  ``STORE_VERSION`` and a SHA-256 over its canonical payload JSON.
* **corrupt/stale fallback** — any read failure (truncated file, bad
  checksum, version bump, key mismatch, unparsable JSON) counts one
  ``store_invalid`` and returns a miss: the caller profiles cold and the
  next save overwrites the bad entry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.signature import Signature

#: bump when the entry layout or the meaning of a persisted field
#: changes; entries from other versions are stale by definition and
#: degrade to cold profiles.  Version 2: a CUDA wall time is a captured
#: graph's replays (``Signature.timing`` records how each was taken),
#: where version 1's was eager dispatch, so a version-1 wall must not
#: answer.
STORE_VERSION = 2

#: the store-key components, in order.  The device key takes the
#: reference's mesh key's place.  The substrate is not a separate
#: component: it lives inside each node's structural P key, so it is
#: already part of the shape signature.
KEY_COMPONENTS = ("shape_signature", "device_key", "substrate")

_TMP_COUNTER = itertools.count()


def device_key(device: torch.device) -> Tuple:
    """What a persisted signature was measured on: device type, card
    name, compute capability, torch version and CUDA version.  A CPU
    device has no card name or capability."""
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        capability = tuple(torch.cuda.get_device_capability(device))
    else:
        name, capability = device.type, ()
    return ("__device__", device.type, name, capability, torch.__version__,
            str(torch.version.cuda))


def canonical_key(sig_key: Any) -> str:
    """Canonical text form of a cache key (nested tuples of ints and
    strings): ``repr`` is deterministic and injective over that domain."""
    return repr(sig_key)


def key_digest(key_text: str) -> str:
    return hashlib.sha256(key_text.encode("utf-8")).hexdigest()


def _payload_checksum(payload: Any) -> str:
    """SHA-256 over the canonical payload JSON (sorted keys, so the
    checksum is insensitive to dict insertion order on either side)."""
    text = json.dumps(payload, sort_keys=True, default=float)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically: unique temp file in the
    same directory (rename is only atomic within a filesystem), flush +
    fsync, then ``os.replace``.  A reader never observes a partial file,
    and concurrent writers each commit a complete one (last wins)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = (f"{path}.tmp.{os.getpid()}.{threading.get_ident()}."
           f"{next(_TMP_COUNTER)}")
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ProxyStore:
    """Directory-backed store of eval-form signature entries and tuned
    proxy reports.

    Layout::

        <root>/sig/<aa>/<digest>.json      signature entries (cache key)
        <root>/report/<digest>.json        ProxyReport + proxy_json

    One store may be shared by sessions on different devices and
    substrates — the key carries both, so entries never alias.
    All methods are thread-safe; cross-process safety comes from the
    atomic rename and from validation at read time.
    """

    def __init__(self, root: str, max_entries: Optional[int] = None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        #: signature-entry cap: when set, every put sweeps the sig tree
        #: and unlinks the least-recently-used files (LRU by mtime —
        #: get_signature touches entries it serves) down to the cap.
        #: None = unbounded, the legacy behaviour.
        self.max_entries = (int(max_entries) if max_entries is not None
                            else None)
        if self.max_entries is not None and self.max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, "
                             f"got {self.max_entries}")
        self.hits = 0
        self.misses = 0
        self.invalid = 0
        self.saves = 0
        self.evicted = 0
        self.report_hits = 0
        self.report_misses = 0

    # -- paths ---------------------------------------------------------------
    def _sig_path(self, digest: str) -> str:
        return os.path.join(self.root, "sig", digest[:2], f"{digest}.json")

    def _report_path(self, digest: str) -> str:
        return os.path.join(self.root, "report", f"{digest}.json")

    # -- envelope ------------------------------------------------------------
    def _write_entry(self, path: str, kind: str, key_text: str,
                     payload: Any) -> None:
        doc = {"version": STORE_VERSION, "kind": kind, "key": key_text,
               "checksum": _payload_checksum(payload), "payload": payload}
        atomic_write_text(path, json.dumps(doc, indent=1, default=float))
        with self._lock:
            self.saves += 1

    def _read_entry(self, path: str, kind: str,
                    key_text: str) -> Optional[Any]:
        """Validated payload, or None.  Distinguishes absent (miss) from
        present-but-bad (invalid); both return None."""
        try:
            with open(path) as f:
                text = f.read()
        except FileNotFoundError:
            return None
        except OSError:
            self._count_invalid()
            return None
        try:
            doc = json.loads(text)
            if doc.get("version") != STORE_VERSION:
                raise ValueError("stale store version")
            if doc.get("kind") != kind:
                raise ValueError("entry kind mismatch")
            if doc.get("key") != key_text:
                raise ValueError("key mismatch (digest collision?)")
            payload = doc["payload"]
            if _payload_checksum(payload) != doc.get("checksum"):
                raise ValueError("checksum mismatch")
            return payload
        except Exception:  # noqa: BLE001 — the fallback policy is total
            self._count_invalid()
            return None

    def _count_invalid(self) -> None:
        with self._lock:
            self.invalid += 1

    # -- signature entries ---------------------------------------------------
    def put_signature(self, sig_key: Any, signature: Signature, *,
                      run: bool) -> None:
        """Persist one eval-form signature under its cache key.

        ``run`` records whether ``signature.wall_time`` (and hence the
        rate metrics) was measured; a stored entry only serves sessions
        with the same setting."""
        key_text = canonical_key(sig_key)
        payload = {"signature": dataclasses.asdict(signature),
                   "run": bool(run)}
        self._write_entry(self._sig_path(key_digest(key_text)),
                          "signature", key_text, payload)
        self._sweep()

    def _sig_files(self) -> list:
        """Every signature-entry file currently on disk, as ``(mtime,
        path)`` pairs.  Files vanishing mid-walk (a concurrent sweeper)
        are skipped — disappearance is the goal state, not an error."""
        out = []
        sig_root = os.path.join(self.root, "sig")
        for dirpath, _dirs, files in os.walk(sig_root):
            for fname in files:
                if not fname.endswith(".json"):
                    continue  # a writer's in-flight .tmp file
                path = os.path.join(dirpath, fname)
                try:
                    out.append((os.stat(path).st_mtime, path))
                except OSError:
                    pass
        return out

    def _sweep(self) -> int:
        """LRU-by-mtime eviction down to ``max_entries`` signature
        entries; returns how many files this call unlinked (also summed
        into ``store_evicted``).  No-op without a cap.  Concurrent
        writers/sweepers are safe: unlink targets whole committed files
        (the atomic-rename invariant), a lost race on any single file is
        tolerated, and an evicted entry merely degrades the next reader
        to a cold profile — the universal store fallback."""
        if self.max_entries is None:
            return 0
        files = self._sig_files()
        excess = len(files) - self.max_entries
        if excess <= 0:
            return 0
        removed = 0
        for _mtime, path in sorted(files)[:excess]:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass  # another sweeper won the race
        if removed:
            with self._lock:
                self.evicted += removed
        return removed

    def get_signature(self, sig_key: Any, *,
                      need_wall: bool) -> Optional[Signature]:
        """The stored :class:`Signature` for ``sig_key``, or None.

        ``need_wall=True`` (a ``run=True`` session) only accepts entries
        whose wall time was measured; ``need_wall=False`` only accepts
        ``run=False`` entries — profiled metric vectors must stay
        bit-identical to what a cold profile under the same settings
        would produce, and a run-measured entry carries rate metrics a
        run=False session must not report."""
        key_text = canonical_key(sig_key)
        payload = self._read_entry(self._sig_path(key_digest(key_text)),
                                   "signature", key_text)
        if payload is None:
            with self._lock:
                self.misses += 1
            return None
        try:
            if bool(payload.get("run")) != bool(need_wall):
                with self._lock:
                    self.misses += 1
                return None
            sig = Signature(**payload["signature"])
        except Exception:  # noqa: BLE001 — any malformed persisted
            # entry (missing keys, wrong types) is the fallback
            # triad's 'invalid' case: count it and profile again
            self._count_invalid()
            return None
        with self._lock:
            self.hits += 1
        if self.max_entries is not None:
            # LRU freshness: a served entry is recently used.  Best
            # effort — a concurrent eviction of this very file is fine
            # (the signature is already in hand).
            try:
                os.utime(self._sig_path(key_digest(key_text)))
            except OSError:
                pass
        return sig

    # -- report entries ------------------------------------------------------
    def put_report(self, report_key: Mapping[str, Any],
                   report: Mapping[str, Any] | Any,
                   proxy_json: str) -> None:
        """Persist a tuned proxy artifact: the ProxyReport (dataclass or
        plain mapping) plus the replayable ``proxy_json``."""
        if dataclasses.is_dataclass(report):
            report = dataclasses.asdict(report)
        key_text = json.dumps(dict(report_key), sort_keys=True, default=str)
        payload = {"report": report, "proxy_json": proxy_json}
        self._write_entry(self._report_path(key_digest(key_text)),
                          "report", key_text, payload)

    def get_report(self, report_key: Mapping[str, Any]
                   ) -> Optional[Dict[str, Any]]:
        """``{"report": dict, "proxy_json": str}`` or None."""
        key_text = json.dumps(dict(report_key), sort_keys=True, default=str)
        payload = self._read_entry(self._report_path(key_digest(key_text)),
                                   "report", key_text)
        with self._lock:
            if payload is None:
                self.report_misses += 1
            else:
                self.report_hits += 1
        return payload

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"store_hits": self.hits, "store_misses": self.misses,
                    "store_invalid": self.invalid, "store_saves": self.saves,
                    "store_evicted": self.evicted,
                    "store_report_hits": self.report_hits,
                    "store_report_misses": self.report_misses}
