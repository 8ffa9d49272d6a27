"""MoE dispatch's tensor-core form, on the CPU: the shapes the card checks
against the JAX package, the wrapper's choice of form, the build's view of the CUDA sources, and the variants that
``repro_torch.bench.moe_breakdown`` times on the card.

The kernel itself (``csrc/moe_dispatch.cu``) runs only on the card, where
``test_torch_cuda.py`` and ``chip_smoke.py`` hold it against the plain
version at these same shapes.  Here the plain version, which the wrapper
runs for CPU tensors, is held against the reference's Pallas kernel in
interpret mode, so those shapes have a JAX oracle.

Tolerances: one-hot masks exact (one product with 1.0 plus zeros); dense
masks as on the card, with f32 x ``rtol=atol=1e-4`` (at T = 300 sums of
terms up to about 35 cancel to values near 0, where reassociation moves
the last bits: 2e-5 seen), with bf16 x ``rtol=atol=1e-2`` (the f32 sums,
reassociated, each rounded once to bf16).
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_jax, to_torch

from repro.kernels import ops as jops
from repro_torch.bench import moe_breakdown
from repro_torch.kernels import _build
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.kernels import ops as tops

#: (T, E, C, D): two C and D tiles with 16-byte rows and a ragged slab;
#: C and D that rule out vector loads; a tiny ragged one; C one row past
#: the f32 form's 256-row tile with D off its 128 columns, and C, D past
#: both on 16-byte rows
CARD_SHAPES = [(200, 3, 136, 264), (300, 5, 70, 130), (37, 3, 5, 24),
               (200, 3, 257, 130), (64, 2, 260, 132)]
#: (mask dtype, x dtype): every form moe_dispatch.cu compiles
DTYPES = [("float32", "float32"), ("bfloat16", "float32"),
          ("float32", "bfloat16"), ("bfloat16", "bfloat16")]


def _mask(kind: str, t: int, e: int, c: int) -> np.ndarray:
    if kind == "routed":
        ids = (np_rand(50, (t,), "uint32") % e).astype(np.int32)
        return np.asarray(jops.make_dispatch_mask(jnp.asarray(ids), e, c))
    return np_rand(51, (t, e, c), "float32")


@pytest.mark.parametrize("t,e,c,d", CARD_SHAPES)
@pytest.mark.parametrize("mask_kind", ["routed", "dense"])
@pytest.mark.parametrize("mask_dtype,dtype", DTYPES)
def test_plain_version_matches_pallas_at_the_card_shapes(t, e, c, d, mask_kind,
                                                         mask_dtype, dtype):
    mask = _mask(mask_kind, t, e, c)
    x = np_rand(52, (t, d), "float32")
    want = jops.moe_dispatch(to_jax(mask, mask_dtype), to_jax(x, dtype),
                             interpret=True)
    got = tops.moe_dispatch(to_torch(mask, mask_dtype), to_torch(x, dtype))
    assert got.shape == (e, c, d) and got.dtype == getattr(torch, dtype)
    if mask_kind == "routed":
        np.testing.assert_array_equal(as_np(got), as_np(want))
    else:
        tol = 1e-4 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt")])
def test_form_follows_x_dtype(dtype, want):
    # the mask's type and the shapes do not choose the form; the kernel
    # picks its load widths at launch
    assert tmd.form(torch.zeros(8, 130, dtype=dtype)) == want
    assert tmd.form(torch.zeros(8 * 24 + 1, dtype=dtype)[1:]) == want


def test_block_tiles_match_the_source():
    # the wrapper checks the launch grid with each form's capacity tile
    src = (_build.CSRC / "moe_dispatch.cu").read_text()
    f32, tc = src.split("namespace f32 {")[1].split("namespace tc {")
    for form, part in (("simt", f32), ("wgmma", tc)):
        assert re.findall(r"constexpr int BM = (\d+);", part) == [
            str(tmd.BM[form])], form
    assert set(tmd.BM) == set(tmd.FORMS)
    # both grids put D tiles first, capacity tiles second, experts third
    for part in (f32, tc):
        assert re.search(r"grid\(static_cast<unsigned>\(\(D \+ BN - 1\) / BN\),"
                         r"\s*static_cast<unsigned>\(\(C \+ BM - 1\) / BM\),"
                         r"\s*static_cast<unsigned>\(E\)\)", part)


def test_cpu_calls_count_no_launch_of_either_form():
    tops.reset_launches()
    mask = torch.ones(6, 2, 3)
    tops.moe_dispatch(mask, torch.randn(6, 4))
    tops.moe_dispatch(mask, torch.randn(6, 4).to(torch.bfloat16))
    assert tops.moe_dispatch.launches == 0
    assert tops.moe_dispatch.forms == {"wgmma": 0, "simt": 0}
    tops.moe_dispatch.forms["wgmma"] = 3
    tops.reset_launches()
    assert tops.moe_dispatch.forms == {"wgmma": 0, "simt": 0}


def test_build_lists_exactly_the_files_in_csrc():
    listed = _build.SOURCES + _build.HEADERS
    assert len(set(listed)) == len(listed)
    assert set(listed) == {p.name for p in _build.CSRC.iterdir()
                           if p.is_file()}
    assert all(n.endswith(".cu") for n in _build.SOURCES)
    assert all(n.endswith(".cuh") for n in _build.HEADERS)


def test_source_digest_changes_with_every_header(tmp_path, monkeypatch):
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    seen = {_build.source_digest()}
    for name in _build.HEADERS:
        with open(tmp_path / name, "a") as f:
            f.write("\n")
        seen.add(_build.source_digest())
    assert len(seen) == len(_build.HEADERS) + 1


_C_TYPES = {"int": ctypes.c_int, "longlong": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_params(decl: str):
    """The ctypes type of each parameter of a C declaration."""
    return [ctypes.c_void_p if "*" in param else
            _C_TYPES["".join(param.replace("const", "").split()[:-1])]
            for param in decl.split(",")]


def test_ctypes_signatures_match_the_c_entry_points():
    # a mismatch would pass arguments in the wrong registers on the card
    found = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = _c_params(m.group(2))
    for name, argtypes in _build.SIGNATURES.items():
        assert found[name] == argtypes, name


def test_breakdown_variants_cut_what_they_name():
    src = (_build.CSRC / "moe_dispatch.cu").read_text()
    v = moe_breakdown.variant_sources(src)
    assert v["full"] == src
    kept, cut = v["no_refill"].split("#if 0\n")
    cut, rest = cut.split("#endif\n", 1)
    # the refill: the x and mask slabs' loads into the ring, nothing else
    assert "tile.load_b(ns, nk, x_vec);" in cut
    assert "tile.load_a_async(ns, nk);" in cut
    assert "wgmma_commit" not in cut and "cp_async_commit" not in cut
    assert "mma_m64n256k16_bf16_mn(acc" in kept and "tile.load_b" not in rest
    assert "mma_m64n256k16_bf16_mn(acc" not in v["no_wgmma"]
    assert "tile.load_b(ns, nk, x_vec);" in v["no_wgmma"]


def test_breakdown_refuses_a_source_without_its_markers():
    src = (_build.CSRC / "moe_dispatch.cu").read_text()
    with pytest.raises(ValueError, match="breakdown"):
        moe_breakdown.variant_sources(src.replace(moe_breakdown.MMA, ""))


def test_breakdown_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        moe_breakdown.main()
