"""Flash attention's tensor-core and tiled forms, on the CPU: the bf16 and
f32 shapes the card checks against the JAX package, the wrapper's choice
of form, its per-form launch counts, and its query tiles and padded head
widths (both forms, every width up to 256) against the CUDA source.

The kernel itself (``csrc/flash_attention.cu``) runs only on the card,
where ``test_torch_cuda.py`` and ``chip_smoke.py`` hold it against the
plain version at these same shapes.  Here the plain version, which the
wrapper runs for CPU tensors, is held against the reference's Pallas
kernel in interpret mode, so those shapes have a JAX oracle.

Tolerance, per element, as ``chip_smoke.py`` holds the kernel on the
card: ``1e-5 + 1e-2·|want| + 2^-7·(the attention over |v|)``.  The plain
version keeps p in f32 where the Pallas kernel rounds it to bf16 before
the PV product (2^-8 relative each, so at most 2^-8 of the attention
over |v|, taken twice), and both round the output to bf16 (2^-8
relative each, 1e-2 with room).  In f32 the reference's own
``rtol=2e-3, atol=2e-4``, as the card holds the tiled form.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_jax, to_torch

from repro.kernels import ops as jops
from repro_torch.bench import flash_tiles
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

#: (q shape, k/v shape, causal): the bf16 cases of chip_smoke.py's phase
#: 2, all on the wgmma form — D = 64, 128, 192 and 256 ragged under both
#: masks, Sq below and above Skv, and widths padded to the next compiled
#: one: 96, 80 (rows on the 16-byte grid) and 100 (off it) to 128, 32 and
#: 33 (odd) to 64
CARD_CASES = [((2, 130, 4, 64), (2, 130, 4, 64), True),
              ((2, 130, 4, 64), (2, 130, 4, 64), False),
              ((1, 257, 2, 128), (1, 257, 2, 128), True),
              ((1, 257, 2, 128), (1, 257, 2, 128), False),
              ((2, 64, 4, 64), (2, 130, 4, 64), True),
              ((1, 300, 2, 128), (1, 200, 2, 128), True),
              ((1, 130, 2, 128), (1, 257, 2, 128), False),
              ((1, 257, 2, 192), (1, 257, 2, 192), True),
              ((1, 257, 2, 192), (1, 257, 2, 192), False),
              ((1, 130, 2, 192), (1, 257, 2, 192), True),
              ((1, 300, 2, 192), (1, 200, 2, 192), True),
              ((1, 130, 2, 192), (1, 257, 2, 192), False),
              ((1, 257, 2, 256), (1, 257, 2, 256), True),
              ((1, 257, 2, 256), (1, 257, 2, 256), False),
              ((1, 130, 2, 256), (1, 257, 2, 256), True),
              ((1, 300, 2, 256), (1, 200, 2, 256), True),
              ((1, 130, 2, 256), (1, 257, 2, 256), False),
              ((1, 100, 2, 96), (1, 100, 2, 96), True),
              ((2, 130, 4, 32), (2, 130, 4, 32), True),
              ((1, 257, 2, 80), (1, 257, 2, 80), True),
              ((1, 257, 2, 100), (1, 257, 2, 100), True),
              ((1, 130, 2, 100), (1, 200, 2, 100), False),
              ((1, 100, 2, 33), (1, 100, 2, 33), True)]
P_ROUNDING = 2.0 ** -7
#: (q shape, k/v shape, causal): the f32 cases of chip_smoke.py's phase 2,
#: all on the tiled form (128 queries a block) — D = 64, 128, 192 and 256
#: ragged under both masks, Sq below and above Skv past one query tile,
#: and widths padded to the next compiled one: 96, 80 and 100 (rows off
#: the 16-byte grid) to 128, 32 and 33 (odd) to 64
F32_CARD_CASES = [((2, 130, 4, 64), (2, 130, 4, 64), True),
                  ((2, 130, 4, 64), (2, 130, 4, 64), False),
                  ((1, 257, 2, 128), (1, 257, 2, 128), True),
                  ((1, 257, 2, 128), (1, 257, 2, 128), False),
                  ((2, 64, 4, 64), (2, 130, 4, 64), True),
                  ((1, 300, 2, 128), (1, 200, 2, 128), True),
                  ((1, 257, 2, 192), (1, 257, 2, 192), True),
                  ((1, 257, 2, 192), (1, 257, 2, 192), False),
                  ((1, 130, 2, 192), (1, 257, 2, 192), True),
                  ((1, 300, 2, 192), (1, 200, 2, 192), True),
                  ((1, 257, 2, 256), (1, 257, 2, 256), True),
                  ((1, 257, 2, 256), (1, 257, 2, 256), False),
                  ((1, 130, 2, 256), (1, 257, 2, 256), True),
                  ((1, 300, 2, 256), (1, 200, 2, 256), True),
                  ((1, 100, 2, 96), (1, 100, 2, 96), True),
                  ((2, 130, 4, 32), (2, 130, 4, 32), True),
                  ((1, 257, 2, 80), (1, 257, 2, 80), True),
                  ((1, 257, 2, 100), (1, 257, 2, 100), True),
                  ((1, 130, 2, 100), (1, 200, 2, 100), False),
                  ((1, 100, 2, 33), (1, 100, 2, 33), True)]


@pytest.mark.parametrize("q_shape,kv_shape,causal", CARD_CASES)
def test_plain_version_matches_pallas_at_the_card_shapes(q_shape, kv_shape,
                                                         causal):
    q = np_rand(40, q_shape, "float32")
    k, v = np_rand(41, kv_shape, "float32"), np_rand(42, kv_shape, "float32")
    want = jops.flash_attention(*(to_jax(a, "bfloat16") for a in (q, k, v)),
                                causal=causal, interpret=True)
    tq, tk, tv = (to_torch(a, "bfloat16") for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == q_shape and got.dtype == torch.bfloat16
    over_abs_v = ref.flash_attention(tq.float(), tk.float(), tv.float().abs(),
                                     causal)
    w = as_np(want)
    limit = 1e-5 + 1e-2 * np.abs(w) + P_ROUNDING * as_np(over_abs_v)
    assert (np.abs(as_np(got) - w) <= limit).all()


@pytest.mark.parametrize("q_shape,kv_shape,causal", F32_CARD_CASES)
def test_plain_version_matches_pallas_at_the_f32_card_shapes(q_shape,
                                                             kv_shape,
                                                             causal):
    q = np_rand(43, q_shape, "float32")
    k, v = np_rand(44, kv_shape, "float32"), np_rand(45, kv_shape, "float32")
    want = jops.flash_attention(*(to_jax(a, "float32") for a in (q, k, v)),
                                causal=causal, interpret=True)
    got = tops.flash_attention(*(to_torch(a, "float32") for a in (q, k, v)),
                               causal=causal)
    assert got.shape == q_shape and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 96, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "tiled"),
    (torch.float32, 128, "tiled"), (torch.float32, 96, "tiled"),
    (torch.float32, 192, "tiled"), (torch.bfloat16, 192, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 100, "wgmma"),
    (torch.float32, 80, "tiled"), (torch.float32, 100, "tiled")])
def test_form_follows_dtype_and_head_width(dtype, d, want):
    assert tfa.form(torch.zeros(1, 8, 2, d, dtype=dtype)) == want
    # the (S, D) layout, and a base off the 16-byte grid: the kernel picks
    # its load widths itself, so neither changes the form
    assert tfa.form(torch.zeros(8, d, dtype=dtype)) == want
    assert tfa.form(torch.zeros(8 * d + 1, dtype=dtype)[1:].view(8, d)) == want


@pytest.mark.parametrize("d,want", [
    (1, 64), (32, 64), (33, 64), (64, 64), (65, 128), (80, 128),
    (96, 128), (100, 128), (128, 128), (129, 192), (192, 192),
    (193, 256), (256, 256)])
def test_padded_width_is_the_next_compiled_width(d, want):
    assert tfa.padded_width(d) == want


@pytest.mark.parametrize("d", [0, 257])
def test_padded_width_refuses_widths_the_kernel_does_not_take(d):
    with pytest.raises(ValueError, match="head widths"):
        tfa.padded_width(d)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_card_cases_are_chip_smokes():
    # the shapes held here against the Pallas kernel are the ones the card
    # holds the kernel to
    assert list(_chip_smoke().FLASH_BF16_SMALL) == CARD_CASES


def test_f32_card_cases_are_chip_smokes():
    # likewise in f32, where they cover every padded width
    cases = list(_chip_smoke().FLASH_F32_SMALL)
    assert cases == F32_CARD_CASES
    assert {tfa.padded_width(q[-1]) for q, _, _ in cases} == set(tfa.TILED_D)


def test_cpu_calls_count_no_launch_of_either_form():
    tops.reset_launches()
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                     (torch.float32, 64), (torch.bfloat16, 96)):
        x = torch.randn(1, 16, 2, d).to(dtype)
        tops.flash_attention(x, x, x)
    assert tops.flash_attention.launches == 0
    assert tops.flash_attention.forms == {"wgmma": 0, "tiled": 0}
    tops.flash_attention.forms["wgmma"] = 2
    tops.flash_attention.forms["tiled"] = 1
    tops.reset_launches()
    assert tops.flash_attention.forms == {"wgmma": 0, "tiled": 0}


def test_query_tiles_match_the_source():
    # the wrapper counts the launch grid with each form's query tile
    src = (_build.CSRC / "flash_attention.cu").read_text()
    head, rest = src.split("namespace tiled {")
    tiled, tc = rest.split("namespace tc {")
    assert "constexpr int BQ" not in head  # no third form's tile
    for form, part in (("tiled", tiled), ("wgmma", tc)):
        assert re.findall(r"constexpr int BQ = (\d+);", part) == [
            str(tfa.BQ[form])], form
    assert set(tfa.BQ) == set(tfa.FORMS) == {"wgmma", "tiled"}
    # the widths each form is compiled for, as its static_assert names
    # them
    for part in (tiled, tc):
        assert [int(w) for w in re.findall(
            r"DP == (\d+)", part.split("static_assert(", 1)[1].split(";", 1)[0])
        ] == list(tfa.WGMMA_D) == list(tfa.TILED_D) == [64, 128, 192, 256]
    # the C dispatch sends each type at every width to the next compiled
    # one up, as padded_width does
    for name, ns in (("dispatch_bf16", "tc"), ("dispatch_f32", "tiled")):
        body = src.split(f"int {name}(", 1)[1].split("\n}\n", 1)[0]
        steps = re.findall(rf"if \(D <= (\d+)\) return {ns}::launch<(\d+)>",
                           body)
        assert steps == [(str(w), str(w)) for w in tfa.WGMMA_D[:-1]], name
        assert re.findall(rf"\n  return {ns}::launch<(\d+)>", body) == [
            str(tfa.WGMMA_D[-1])], name
    # no generic SIMT kernel is left beside the two forms
    assert not re.search(r"\bflash_kernel\b", src)
    assert "simt" not in src.lower()


@pytest.mark.parametrize("name", sorted(flash_tiles.VARIANTS))
def test_tile_variants_change_only_the_tiled_form(name):
    # each copy repro_torch.bench.flash_tiles times differs from the tree
    # in the tiled form's constants it names and its fixed-D line alone
    src = (_build.CSRC / "flash_attention.cu").read_text()
    change = flash_tiles.VARIANTS[name]
    got = flash_tiles.variant_source(src, change)
    assert got.split("namespace tc {")[1] == src.split("namespace tc {")[1]
    before, after = src.splitlines(), got.splitlines()
    assert len(before) == len(after)
    changed = [(a, b) for a, b in zip(before, after) if a != b]
    tiled = src.split("namespace tiled {")[1].split("namespace tc {")[0]
    lines = tiled.splitlines()
    want = []
    for i, a in enumerate(lines):
        fixed = change.get("fixed")
        if (fixed and a.startswith("  if constexpr (DP <= ")
                and "flash_f32<DP, true>" in lines[i + 1]
                and a != re.sub(r"\d+", str(fixed), a)):
            want.append((a, re.sub(r"\d+", str(fixed), a)))
        for dp, consts in change.items():
            for name_, value in ({} if dp == "fixed" else consts).items():
                if a.startswith(f"  static constexpr int {name_} = "):
                    want.append((a, a.replace(" = ", f" = DP == {dp} ? "
                                              f"{value} : ", 1)))
    assert changed == want
    assert bool(changed) == bool(change)


def test_tile_variants_refuse_a_source_without_their_lines():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    with pytest.raises(ValueError, match="fixed-D"):
        flash_tiles.variant_source(src.replace("flash_f32<DP, true>", "x"),
                                   {"fixed": 256})
    with pytest.raises(ValueError, match="PV_UNROLL"):
        flash_tiles.variant_source(src.replace("PV_UNROLL = ", "PV = "),
                                   {256: {"PV_UNROLL": 8}})


def test_tile_bench_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        flash_tiles.main()
