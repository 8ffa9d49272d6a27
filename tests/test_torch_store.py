"""The port's persistent ``ProxyStore`` (``repro_torch.core.store``)
against the reference's contract: warm starts profile nothing and give
bit-equal metrics (in process and in a fresh process that imports only
``repro_torch``), the run flag and the corrupt/stale triad degrade to a
cold profile with a counted ``store_invalid``, writes are atomic, the cap
sweep is LRU, reports round-trip — and the port's key carries a device
key, so an entry measured on another device, or written by the reference
package's store for the same proxy, is a miss.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro.core import EvalSession as JEvalSession
from repro.core import ProxyStore as JProxyStore
from repro.core import store as jstore
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import MotifNode as JMotifNode
from repro.core.proxy_graph import ProxyBenchmark as JProxyBenchmark
from repro_torch.core import EvalSession, ProxyStore
from repro_torch.core import store as tstore
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.core.signature import Signature
from repro_torch.core.store import (STORE_VERSION, atomic_write_text,
                                    canonical_key, device_key, key_digest)

ROOT = Path(__file__).resolve().parents[1]
P = dict(data_size=1 << 10, chunk_size=1 << 6, num_tasks=2, batch_size=2,
         height=8, width=8, channels=4)


def _pb(motif="sort", **updates) -> ProxyBenchmark:
    pb = ProxyBenchmark(f"t_{motif}", (MotifNode(
        "n0", motif, "", PVector(**P).replace(**updates)),))
    pb.validate()
    return pb


def _session(tmp_path, run=False) -> EvalSession:
    return EvalSession(run=run, seed=0, device="cpu",
                       store=ProxyStore(str(tmp_path)))


def _entry_path(session: EvalSession, pb: ProxyBenchmark) -> str:
    key = session.cache.store_key(session.cache.key_for(pb))
    return session.store._sig_path(key_digest(canonical_key(key)))


def test_store_contract_constants():
    # the port's own bump: its CUDA walls are captured-graph replays
    assert STORE_VERSION == jstore.STORE_VERSION + 1
    assert tstore.KEY_COMPONENTS == ("shape_signature", "device_key",
                                     "substrate")
    assert device_key(torch.device("cpu")) == (
        "__device__", "cpu", "cpu", (), torch.__version__,
        str(torch.version.cuda))


# -- round trip -----------------------------------------------------------------


@pytest.mark.parametrize("motif", ["sort", "statistics", "logic"])
def test_warm_start_zero_compiles_bit_identical(tmp_path, motif):
    cold = _session(tmp_path)
    m_cold = cold.evaluate(_pb(motif))
    assert cold.stats()["compiles"] == 1 and cold.stats()["store_saves"] == 1
    warm = _session(tmp_path)
    m_warm = warm.evaluate(_pb(motif))
    s = warm.stats()
    assert s["compiles"] == 0 and s["store_hits"] == 1
    assert m_warm == m_cold  # bit-identical, not approximately
    assert warm.signature_of(_pb(motif)) == cold.signature_of(_pb(motif))


def test_cross_process_warm_start(tmp_path):
    """A fresh python process that imports only ``repro_torch`` replays the
    stored class with 0 profiles and bit-equal metrics."""
    m_ref = _session(tmp_path).evaluate(_pb())
    code = f"""
import json, sys
from repro_torch.core import EvalSession, ProxyStore, PVector
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
pb = ProxyBenchmark("t_sort", (MotifNode("n0", "sort", "",
                                         PVector(**{P!r})),))
s = EvalSession(run=False, seed=0, device="cpu",
                store=ProxyStore({str(tmp_path)!r}))
m = s.evaluate(pb)
mods = sorted({{n.split(".")[0] for n in sys.modules}} & {{"jax", "repro"}})
print("RESULT:" + json.dumps({{"m": m, "stats": s.stats(), "mods": mods}}))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT:")][0]
    doc = json.loads(line[len("RESULT:"):])
    assert doc["mods"] == []
    assert doc["stats"]["compiles"] == 0
    assert doc["stats"]["store_hits"] == 1
    assert doc["m"] == m_ref


def test_run_flag_mismatch_is_a_miss(tmp_path):
    """A run=False entry never serves a run=True session (it has no wall
    time) and the other way round (rate metrics would leak)."""
    _session(tmp_path).evaluate(_pb())
    run_sess = _session(tmp_path, run=True)
    m = run_sess.evaluate(_pb())
    s = run_sess.stats()
    assert s["compiles"] == 1 and s["store_hits"] == 0
    assert "flops_rate" in m
    warm = _session(tmp_path, run=True)
    assert warm.evaluate(_pb()) == m
    assert warm.stats()["compiles"] == 0
    # the run=True save overwrote the run=False entry: a run=False
    # session is now the one refused
    cold = _session(tmp_path)
    cold.evaluate(_pb())
    assert cold.stats()["compiles"] == 1 and cold.stats()["store_hits"] == 0


def test_report_round_trip(tmp_path):
    store = ProxyStore(str(tmp_path))
    key = {"workload": "kmeans", "device": "cpu", "scale": 0.5}
    report = {"name": "kmeans", "qualified": False, "mean_accuracy": 0.6}
    store.put_report(key, report, proxy_json='{"nodes": []}')
    assert store.get_report(key) == {"report": report,
                                     "proxy_json": '{"nodes": []}'}
    assert store.get_report({**key, "scale": 1.0}) is None
    assert store.stats()["store_report_hits"] == 1
    assert store.stats()["store_report_misses"] == 1
    # a dataclass report is stored as its dict
    sig = Signature(flops=3.0, op_mix={"sort": 1.0})
    store.put_report({"k": 1}, sig, proxy_json="{}")
    assert store.get_report({"k": 1})["report"] == dataclasses.asdict(sig)


def test_stats_keys_equal_the_reference(tmp_path):
    assert set(ProxyStore(str(tmp_path / "t")).stats()) == set(
        JProxyStore(str(tmp_path / "j")).stats())


# -- the device key ---------------------------------------------------------------


def test_an_entry_under_another_device_key_is_a_miss(tmp_path):
    cold = _session(tmp_path)
    m = cold.evaluate(_pb())
    sig = cold.signature_of(_pb())
    # the same proxy's entry as a card would have written it, and no other
    other = ("__device__", "cuda", "NVIDIA H100 80GB HBM3", (9, 0),
             torch.__version__, "12.8")
    store = ProxyStore(str(tmp_path / "card"))
    store.put_signature(cold.cache.key_for(_pb()) + (other,), sig, run=False)
    sess = EvalSession(run=False, seed=0, device="cpu", store=store)
    assert sess.evaluate(_pb()) == m
    s = sess.stats()
    assert s["compiles"] == 1 and s["store_hits"] == 0
    assert s["store_misses"] == 1 and s["store_invalid"] == 0


def test_a_reference_store_entry_for_the_same_proxy_is_a_miss(tmp_path):
    jpb = JProxyBenchmark("t_sort", (JMotifNode("n0", "sort", "",
                                                JPVector(**P)),))
    jsess = JEvalSession(run=False, seed=0, store=JProxyStore(str(tmp_path)))
    jsess.evaluate(jpb)
    assert jsess.stats()["store_saves"] == 1
    sess = _session(tmp_path)
    # the in-memory keys are the same tuple: only the device key keeps
    # the reference's entry (a JAX profile) from serving the port
    assert sess.cache.key_for(_pb()) == jsess.cache.key_for(jpb)
    sess.evaluate(_pb())
    s = sess.stats()
    assert s["compiles"] == 1 and s["store_hits"] == 0
    assert s["store_misses"] == 1 and s["store_invalid"] == 0
    # both entries now sit side by side, and neither package reads the other's
    again = JEvalSession(run=False, seed=0, store=JProxyStore(str(tmp_path)))
    again.evaluate(jpb)
    assert again.stats()["compiles"] == 0
    assert again.stats()["store_hits"] == 1


# -- the corrupt/stale fallback ---------------------------------------------------


def _corrupt(path: str, case: str) -> str:
    doc = json.loads(Path(path).read_text())
    if case == "truncated":
        text = json.dumps(doc)
        return text[: len(text) // 2]
    if case == "bad_checksum":
        doc["checksum"] = "0" * 64
    elif case == "version_bumped":
        doc["version"] = STORE_VERSION + 1
    else:  # key_mismatch: a digest collision or a renamed file
        doc["key"] = "('somebody', 'else')"
    return json.dumps(doc)


@pytest.mark.parametrize("case", ["truncated", "bad_checksum",
                                  "version_bumped", "key_mismatch"])
def test_bad_entry_degrades_to_a_cold_profile(tmp_path, case):
    cold = _session(tmp_path)
    m_ref = cold.evaluate(_pb())
    path = _entry_path(cold, _pb())
    Path(path).write_text(_corrupt(path, case))
    warm = _session(tmp_path)
    m = warm.evaluate(_pb())  # must not raise
    s = warm.stats()
    assert s["store_invalid"] == 1 and s["store_hits"] == 0
    assert s["compiles"] == 1
    assert m == m_ref
    # the cold profile overwrote the bad entry: the next one is served
    again = _session(tmp_path)
    assert again.evaluate(_pb()) == m_ref
    assert again.stats()["compiles"] == 0


def test_a_failed_store_write_does_not_stop_tuning(tmp_path, monkeypatch):
    sess = _session(tmp_path)

    def full(*a, **k):
        raise OSError("no space left on device")

    monkeypatch.setattr(sess.store, "put_signature", full)
    m = sess.evaluate(_pb())
    assert sess.stats()["compiles"] == 1 and sess.stats()["store_saves"] == 0
    monkeypatch.undo()
    assert _session(tmp_path).evaluate(_pb()) == m


# -- atomic writes ------------------------------------------------------------------


def test_atomic_write_leaves_no_temp_files(tmp_path, monkeypatch):
    target = tmp_path / "out.json"
    atomic_write_text(str(target), '{"a": 1}')
    atomic_write_text(str(target), '{"a": 2}')
    assert json.loads(target.read_text()) == {"a": 2}

    def boom(src, dst):  # dying after the temp write, before the rename
        raise OSError("killed mid-rename")

    monkeypatch.setattr(tstore.os, "replace", boom)
    with pytest.raises(OSError):
        atomic_write_text(str(target), '{"a": "torn"}')
    monkeypatch.undo()
    assert json.loads(target.read_text()) == {"a": 2}
    assert os.listdir(tmp_path) == ["out.json"]


def test_concurrent_writers_leave_a_valid_entry(tmp_path):
    sess = _session(tmp_path)
    sess.evaluate(_pb())
    key = sess.cache.store_key(sess.cache.key_for(_pb()))
    sig = sess.signature_of(_pb())
    store, errors = sess.store, []

    def writer():
        for _ in range(20):
            try:
                store.put_signature(key, sig, run=False)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

    def reader():
        for _ in range(40):
            try:
                assert store.get_signature(key, need_wall=False) is not None
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

    threads = ([threading.Thread(target=writer) for _ in range(4)]
               + [threading.Thread(target=reader) for _ in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and store.invalid == 0
    assert store.get_signature(key, need_wall=False) == sig
    leftovers = [f for _, _, fs in os.walk(tmp_path) for f in fs
                 if not f.endswith(".json")]
    assert leftovers == []


# -- the capped store ------------------------------------------------------------------


def _sig_count(store) -> int:
    return sum(f.endswith(".json") for _, _, fs in
               os.walk(os.path.join(store.root, "sig")) for f in fs)


@pytest.mark.parametrize("cap,puts", [(3, 8), (1, 4), (5, 5)])
def test_capped_store_sweeps_like_the_reference(tmp_path, cap, puts):
    from repro.core.signature import Signature as JSignature

    def fill(mod_store, sig_cls, root):
        store = mod_store(str(root), max_entries=cap)
        for i in range(puts):
            store.put_signature(("k", i), sig_cls(flops=float(i)),
                                run=False)
            path = store._sig_path(key_digest(canonical_key(("k", i))))
            os.utime(path, (1000.0 + i, 1000.0 + i))  # a strict age order
            store._sweep()
        return store

    got = fill(ProxyStore, Signature, tmp_path / "t")
    want = fill(JProxyStore, JSignature, tmp_path / "j")
    assert _sig_count(got) == _sig_count(want) == min(cap, puts)
    assert got.stats() == want.stats()
    kept = [i for i in range(puts)
            if got.get_signature(("k", i), need_wall=False) is not None]
    assert kept == list(range(puts))[-cap:]


def test_reading_an_entry_touches_it_so_eviction_is_lru(tmp_path):
    store = ProxyStore(str(tmp_path), max_entries=2)
    for i in (1, 2):
        store.put_signature(("k", i), Signature(flops=float(i)), run=False)
        os.utime(store._sig_path(key_digest(canonical_key(("k", i)))),
                 (1000.0 + i, 1000.0 + i))
    assert store.get_signature(("k", 1), need_wall=False) is not None
    store.put_signature(("k", 3), Signature(flops=3.0), run=False)
    assert store.get_signature(("k", 1), need_wall=False) is not None
    assert store.get_signature(("k", 2), need_wall=False) is None
    assert store.stats()["store_evicted"] == 1
    with pytest.raises(ValueError):
        ProxyStore(str(tmp_path / "x"), max_entries=0)
