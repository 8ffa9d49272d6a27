"""The port's ``CheckpointManager`` against the reference's
``repro/checkpoint/manager.py``: the reference's checkpoint tests
(``test_substrates.py``) on the port, and checkpoints crossing between
the packages both ways, bit for bit (f32, int32, uint32, bool and bf16
leaves, nested dict and list keys).

The reference's ``restore`` refuses any bf16 leaf, its own included
(``np.load`` gives the 2-byte void that ``np.save`` wrote, and numpy has
no cast from it to ``ml_dtypes.bfloat16``), so the port's bf16 leaves
are held to the reference's own files byte for byte and read back as
JAX would have to, ``.view(ml_dtypes.bfloat16)``.  The elastic restore
across meshes runs in ``test_torch_pipeline_parallel.py``'s gloo group.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _prop import given, settings, strategies as st

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager


def _state(val=0.0):
    return {"w": torch.full((4, 3), val),
            "opt": {"m": torch.zeros((4, 3)),
                    "step": torch.tensor(0, dtype=torch.int32)}}


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# -- the reference's checkpoint tests, on the port -------------------------


def test_roundtrip_identity(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    s = _state(3.5)
    cm.save(7, s)
    step, r = cm.restore(s)
    assert step == 7
    _assert_same(s, r)


def test_async_save_and_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, _state(1.0), blocking=False)
    cm.wait()
    assert cm.latest_step() == 1


def test_rolling_window_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        cm.save(s, _state(float(s)))
    assert cm.all_steps() == [3, 4]


def test_pinned_steps_survive_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        cm.save(s, _state(float(s)), pinned=(s == 1))
    assert cm.all_steps() == [1, 3, 4]


def test_atomicity_no_tmp_left(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, _state())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The writer thread writes the values of the save call, not what the
    caller did to its tensors afterwards."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    s = _state(1.0)
    cm.save(1, s, blocking=False)
    s["w"].fill_(9.0)
    _, r = cm.restore(_state())
    assert torch.equal(r["w"], torch.full((4, 3), 1.0))


def test_async_writer_error_reraised_in_wait(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as mod

    cm = CheckpointManager(str(tmp_path), keep=2)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(mod, "atomic_write_text", broken)
    cm.save(1, _state(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    cm.wait()  # reported once
    assert cm.all_steps() == []


def test_restore_refuses_missing_leaves_and_shapes(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        cm.restore({"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="checkpoint shape"):
        cm.restore({"a": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_restore_takes_the_prototypes_dtype(tmp_path):
    """As the reference's ``jnp.asarray(arr, proto.dtype)``; a meta
    prototype (shape and dtype only) restores onto the device asked
    for."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, {"a": torch.arange(4, dtype=torch.int32)})
    _, r = cm.restore({"a": torch.empty(4, dtype=torch.float64,
                                        device="meta")}, device="cpu")
    assert r["a"].dtype == torch.float64 and r["a"].device.type == "cpu"
    assert r["a"].tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("proto", ["meta", "record"])
def test_restore_of_a_dataless_prototype_defaults_to_cuda(
        tmp_path, monkeypatch, proto):
    """A meta tensor or a ``shape``/``dtype`` record carries no device:
    its leaf goes where the port runs, the card, unless the caller asks
    for the CPU (``resolve_device(None)``, as the reference's
    ``jnp.asarray`` puts it on the default device)."""
    from types import SimpleNamespace

    from repro_torch.checkpoint import manager as mod

    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("cpu")

    monkeypatch.setattr(mod, "resolve_device", resolve)
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, {"a": torch.arange(4, dtype=torch.int32)})
    like = (torch.empty(4, dtype=torch.int32, device="meta")
            if proto == "meta"
            else SimpleNamespace(shape=(4,), dtype=torch.int32))
    _, r = cm.restore({"a": like})
    assert asked == [None]
    assert r["a"].tolist() == [0, 1, 2, 3]
    if not torch.cuda.is_available():
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cm.restore({"a": like})


@given(st.integers(min_value=0, max_value=1000))
@settings(max_examples=10, deadline=None)
def test_restore_is_identity_property(tmp_path_factory, seed):
    tmp = tmp_path_factory.mktemp(f"ck{seed}")
    cm = CheckpointManager(str(tmp), keep=1)
    g = np.random.default_rng(seed)
    s = {"a": torch.from_numpy(g.standard_normal(5).astype(np.float32)),
         "b": torch.from_numpy(g.integers(0, 2**32, (3, 2),
                                          dtype=np.uint32).view(np.int32)
                               ).view(torch.uint32)}
    cm.save(seed, s)
    _, r = cm.restore(s)
    assert torch.equal(r["a"], s["a"])
    assert r["b"].dtype == torch.uint32
    assert torch.equal(r["b"].view(torch.int32), s["b"].view(torch.int32))


def test_kill_during_manifest_write_preserves_previous_checkpoint(
        tmp_path, monkeypatch):
    """A process killed while the manifest is being written must leave
    the previous checkpoint fully restorable and never expose a partial
    step: the manifest rides atomic_write_text and the step directory
    only becomes visible at the final rename."""
    import repro_torch.core.store as store_mod

    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, _state(1.0))
    assert cm.all_steps() == [1]

    def killed(src, dst):
        raise OSError("killed mid-manifest-commit")

    monkeypatch.setattr(store_mod.os, "replace", killed)
    with pytest.raises(OSError, match="killed"):
        cm.save(2, _state(2.0))
    monkeypatch.undo()

    assert cm.all_steps() == [1]
    step, r = cm.restore(_state())
    assert step == 1
    _assert_same(_state(1.0), r)

    cm.save(2, _state(2.0))
    assert cm.all_steps() == [1, 2]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


# -- across the packages ----------------------------------------------------


def _numpy_state(seed=3):
    """One state as numpy leaves (bf16 as ``ml_dtypes``), in insertion
    order the reference would not keep: the on-disk leaf order is the
    sorted one in both packages."""
    g = np.random.default_rng(seed)
    return {
        "w": g.standard_normal((5, 3)).astype(np.float32),
        "opt": {"step": np.asarray(7, np.int32),
                "m": [g.standard_normal(4).astype(np.float32),
                      {"mask": g.integers(0, 2, 6).astype(bool)}]},
        "keys": g.integers(0, 2**32, 9, dtype=np.uint32),
        "b": g.standard_normal(11).astype(ml_dtypes.bfloat16),
    }


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    def one(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        if a.dtype == np.uint32:
            return torch.from_numpy(a.view(np.int32).copy()).view(
                torch.uint32)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(one, tree)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _np_bits(a: np.ndarray) -> np.ndarray:
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".npy")}


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    ref = _numpy_state()
    JCheckpointManager(str(tmp_path), keep=2).save(4, _to_jax(ref))
    like = _to_torch(ref)
    step, got = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 4
    flat_want = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, want in flat_want:
        node = got
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert node.dtype == _to_torch(want).dtype, path
        np.testing.assert_array_equal(_torch_bits(node), _np_bits(want))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """Every leaf but bf16 through the reference's ``restore``, bit for
    bit; the bf16 leaf from the file as JAX reads it (the reference's
    restore refuses its own bf16 leaves alike)."""
    ref = _numpy_state()
    CheckpointManager(str(tmp_path), keep=2).save(4, _to_torch(ref))
    no_bf16 = {k: v for k, v in ref.items() if k != "b"}
    step, got = JCheckpointManager(str(tmp_path)).restore(_to_jax(no_bf16))
    assert step == 4
    for a, b in zip(jax.tree.leaves(no_bf16), jax.tree.leaves(got)):
        assert np.asarray(b).dtype == a.dtype
        np.testing.assert_array_equal(_np_bits(np.asarray(b)), _np_bits(a))
    m = _manifest(tmp_path / "step_4")
    entry = next(e for e in m["leaves"] if e["key"] == "b")
    assert entry["dtype"] == "bfloat16"
    raw = np.load(tmp_path / "step_4" / entry["file"])
    np.testing.assert_array_equal(raw.view(ml_dtypes.bfloat16).view(
        np.int16), ref["b"].view(np.int16))
    JCheckpointManager(str(tmp_path / "jax")).save(4, _to_jax(ref))
    for d in (tmp_path, tmp_path / "jax"):  # the port's file, its own
        with pytest.raises(ValueError, match="No cast function"):
            JCheckpointManager(str(d)).restore(_to_jax({"b": ref["b"]}))


def test_on_disk_form_is_the_references(tmp_path):
    """The same state written by both packages: every ``.npy`` byte for
    byte (the bf16 leaf's ``<V2`` header included) and the manifests
    equal but for the write time."""
    ref = _numpy_state()
    JCheckpointManager(str(tmp_path / "jax"), keep=2).save(2, _to_jax(ref))
    CheckpointManager(str(tmp_path / "port"), keep=2).save(2, _to_torch(ref))
    jdir, tdir = tmp_path / "jax" / "step_2", tmp_path / "port" / "step_2"
    assert _files(jdir) == _files(tdir)
    assert _manifest(jdir) == _manifest(tdir)


def test_jax_bf16_checkpoint_restores_in_the_port(tmp_path):
    """The bf16 leaf alone, written by the reference, read back by the
    port as its raw 16 bits."""
    b = np.random.default_rng(0).standard_normal(33).astype(
        ml_dtypes.bfloat16)
    JCheckpointManager(str(tmp_path)).save(1, {"b": jnp.asarray(b)})
    _, got = CheckpointManager(str(tmp_path)).restore(
        {"b": torch.empty(33, dtype=torch.bfloat16)})
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].view(torch.int16).numpy(),
                                  b.view(np.int16))
