"""The port's CUDA kernels against their plain PyTorch versions.

These need a CUDA device and skip without one.  The module imports no
JAX, so it also runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

Tolerances as in ``test_torch_kernels.py``: f32 products
``rtol=1e-4, atol=1e-4``, bf16 products ``rtol=1e-2, atol=1e-2``, row
moments ``rtol=1e-4, atol=1e-5``; sorts are exact.  As in
``chip_smoke.py``: rmsnorm f32 ``rtol=1e-5, atol=1e-5`` (rsqrtf and a
reassociated sum), bf16 ``1e-2``; flash attention the reference's
``rtol=2e-3, atol=2e-4`` in f32 and ``5e-2`` in bf16 (sound at these
sequence lengths, where outputs are about 0.2 and more); MoE dispatch
exact on one-hot masks, ``rtol=atol=1e-4`` on a dense mask with f32 x and
``1e-2`` with bf16 x (one bf16 rounding of the f32 sum).
"""
import math

import pytest
import torch

from torch_parity import cuda_device, np_rand, to_torch  # noqa: F401

from repro_torch.core.motifs import MOTIFS
from repro_torch.kernels import bitonic_sort as tbs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trm

MATMUL_SHAPES = [(128, 128, 128), (300, 200, 150), (64, 512, 32),
                 (129, 65, 257)]
MATMUL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
              "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_matmul_matches_plain(cuda_device, dtype):
    for m, k, n in MATMUL_SHAPES:
        x = to_torch(np_rand(1, (m, k), "float32"), dtype).to(cuda_device)
        y = to_torch(np_rand(2, (k, n), "float32"), dtype).to(cuda_device)
        torch.testing.assert_close(tops.matmul(x, y).float(),
                                   tref.matmul(x, y).float(),
                                   **MATMUL_TOL[dtype])


def _on_card(device, seed, shape, dtype, off_grid=False):
    """Seeded data on the card; ``off_grid`` puts its base one element past
    the 16-byte grid (the kernels' scalar loads)."""
    n = math.prod(shape) + int(off_grid)
    t = to_torch(np_rand(seed, (n,), "float32"), dtype).to(device)
    return t[int(off_grid):].view(shape)


# (M, K, N, base off the grid): the wide form's five tiles (chosen by the
# launch from M and N on 132 SMs: 96x128, 128x128, 64x128, 128x64, 64x64),
# K off the 16-byte unit, N either side of both narrow bounds (below and
# from NARROW_FULL_M rows), narrow N from 2, and bases off the grid (the
# wide form's scalar loads, also at a narrow N)
MATMUL_FORM_CASES = [(12288, 64, 128, False), (32768, 64, 128, False),
                     (8192, 64, 128, False), (16384, 64, 64, False),
                     (300, 203, 150, False), (300, 256, 160, True),
                     (4099, 67, 8, False), (4096, 256, 2, False),
                     (1000, 512, tmm.NARROW_SMALL_M_N, False),
                     (1000, 512, tmm.NARROW_SMALL_M_N + 1, False),
                     (tmm.NARROW_FULL_M, 64, tmm.NARROW_N, False),
                     (tmm.NARROW_FULL_M, 64, tmm.NARROW_N + 1, False),
                     (4096, 256, 8, True)]
# (M, K, N, base off the grid): the split form — M = 1, 17, 32, 64 (two
# row tiles) and 128 (four) at long K, the fewest slices (K = 512), N and
# K off the 16-byte unit, a ragged last column tile, a ragged last row
# tile (M = 100), and bases off the grid
MATMUL_SPLIT_CASES = [(32, 2048, 2048, False), (1, 2048, 2048, False),
                      (17, 2048, 2048, False), (64, 2048, 2048, False),
                      (128, 2048, 2048, False), (100, 1024, 500, False),
                      (32, 512, 1000, False), (17, 2050, 2047, False),
                      (33, 1027, 300, False), (32, 2048, 2048, True),
                      (1, 1024, 130, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_matmul_forms_match_plain(cuda_device, dtype):
    tops.reset_launches()
    calls = dict.fromkeys(tmm.FORMS, 0)
    for m, k, n, off in MATMUL_FORM_CASES:
        x = _on_card(cuda_device, 1, (m, k), dtype, off)
        y = _on_card(cuda_device, 2, (k, n), dtype, off)
        torch.testing.assert_close(tops.matmul(x, y).float(),
                                   tref.matmul(x, y).float(),
                                   **MATMUL_TOL[dtype])
        calls[tmm.form(x, y)] += 1
    assert tops.matmul.forms == calls
    assert tops.launch_counts()["matmul"] == len(MATMUL_FORM_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_matmul_split_matches_plain_and_repeats(cuda_device, dtype):
    # K's slices are summed by rank, not in k order, but in a fixed order:
    # two calls on the same input give the same bits
    tops.reset_launches()
    for m, k, n, off in MATMUL_SPLIT_CASES:
        x = _on_card(cuda_device, 1, (m, k), dtype, off)
        y = _on_card(cuda_device, 2, (k, n), dtype, off)
        assert tmm.form(x, y) == "split", (m, k, n, off)
        got = tops.matmul(x, y)
        torch.testing.assert_close(got.float(), tref.matmul(x, y).float(),
                                   **MATMUL_TOL[dtype])
        assert torch.equal(tops.matmul(x, y), got), (m, k, n, off)
    assert tops.matmul.forms["split"] == 2 * len(MATMUL_SPLIT_CASES)


D_ONE = trm.ONE_LAUNCH_BYTES // 16
D_ROW = trm.ONE_LAUNCH_ROW_BYTES // 4
# (rows, D, base off the grid): the main path's shape, either side of the
# one-launch bounds in f32 (the input's, then the row's), split shapes in
# both types, a block-per-row shape off the grid, many short rows
ROW_MOMENTS_CASES = [(1024, 57, False), (4, D_ONE, False),
                     (4, D_ONE + 1, False), (16, D_ROW, False),
                     (16, D_ROW + 1, False), (33, 70_001, False),
                     (16, 1 << 19, False), (33, 4096, True),
                     (600, 2048, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_row_moments_forms_match_plain_and_repeat(cuda_device, dtype):
    tops.reset_launches()
    calls = dict.fromkeys(trm.FORMS, 0)
    for rows, d, off in ROW_MOMENTS_CASES:
        x = _on_card(cuda_device, 3, (rows, d), dtype, off)
        got = tops.row_moments(x)
        for g, w in zip(got, tref.row_moments(x)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        # the same input gives the same bits, call after call
        for g, again in zip(got, tops.row_moments(x)):
            assert torch.equal(g, again)
        calls[trm.form(x)] += 2
    assert tops.row_moments.forms == calls
    assert calls["split"] and calls["one_launch"]
    assert tops.launch_counts()["row_moments"] == 2 * len(ROW_MOMENTS_CASES)


@pytest.mark.cuda
def test_cuda_row_moments_matches_plain(cuda_device):
    x = to_torch(np_rand(3, (8, 70_000), "float32")).to(cuda_device)
    for got, want in zip(tops.row_moments(x), tref.row_moments(x)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# (n, block, base off the grid): the main path's shape, every block from
# 2 to 2^16 (blocks sharing a tile, one tile a block, the 2^15 tile and one
# global pass beyond it), 2^17 to 2^20 (two, three and four strides in one
# global pass; 2^20 is the merge variant's longest run), ragged inputs,
# and a base one element past the 16-byte grid
BITONIC_CASES = ([(5000, 4096, False), (70_001, 1 << 15, False),
                  (9830, 2048, False), (100_003, 4096, True),
                  ((1 << 17) + 5, 1 << 17, False)]
                 + [((1 << b) + 3, 1 << b, False) for b in (18, 19, 20)]
                 + [(3 * (1 << b) + 1, 1 << b, False) for b in range(1, 17)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "bfloat16"])
def test_cuda_bitonic_sort_matches_plain(cuda_device, dtype):
    tops.reset_launches()
    for n, block, off in BITONIC_CASES:
        x = to_torch(np_rand(4, (n + off,), "float32" if dtype == "bfloat16"
                             else dtype), dtype).to(cuda_device)[int(off):]
        want = tref.sort_blocks(x, block, tbs.SENTINELS[x.dtype])
        assert torch.equal(tbs.bitonic_sort_blocks(x, block=block), want), \
            (n, block, off)
    assert tops.launch_counts()["bitonic_sort"] == len(BITONIC_CASES)


@pytest.mark.cuda
def test_cuda_wrappers_count_one_launch_per_call(cuda_device):
    x = torch.randn(64, 32, device=cuda_device)
    tops.reset_launches()
    tops.matmul(x, x.T.contiguous())
    tops.row_moments(x)
    tops.sort(x.reshape(-1), block=256)
    assert tops.launch_counts() == {"matmul": 1, "row_moments": 1,
                                    "bitonic_sort": 1, "rmsnorm": 0,
                                    "flash_attention": 0, "moe_dispatch": 0}
    tops.rmsnorm(x, x[0])
    tops.flash_attention(x, x, x)
    tops.moe_dispatch(tops.make_dispatch_mask(
        torch.arange(64, device=cuda_device) % 4, 4, 16), x)
    assert tops.launch_counts() == {"matmul": 1, "row_moments": 1,
                                    "bitonic_sort": 1, "rmsnorm": 1,
                                    "flash_attention": 1, "moe_dispatch": 1}


def _vmap(fn, *args, in_dims=0):
    """vmap with functorch's per-lane fallback disabled."""
    from repro_torch.core.evaluator import no_vmap_fallback

    with no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=in_dims)(*args)


# (lanes, M, K, N, in_dims): lanes of y alone (x shared, stride 0), of
# both, of x alone (folded into M); the narrow form (N <= 16) and the wide
# one, K off the 16-byte unit; the split form with lanes of both and of x
# alone (which take the lane axis, since folded they would split K
# otherwise)
LANE_MATMUL_CASES = [(2, 300, 64, 8, (None, 0)), (32, 300, 64, 8, (0, 0)),
                     (3, 129, 65, 257, (0, 0)), (32, 96, 128, 128, (0, 0)),
                     (4, 200, 48, 24, (0, None)),
                     (2, 32, 2048, 2048, (0, 0)),
                     (4, 32, 2048, 2048, (0, None))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lane_forms_match_the_loop_in_one_launch(cuda_device, dtype):
    """Each op's vmapped form on the card: one launch for all lanes, each
    lane equal to the op on that lane (the matmul lane bit for bit: it
    runs its own launch's tile, form and k order)."""
    for lanes, m, k, n, dims in LANE_MATMUL_CASES:
        x = _on_card(cuda_device, 1, (lanes, m, k), dtype)
        y = _on_card(cuda_device, 2, (lanes, k, n), dtype)
        xs = x if dims[0] is not None else x[0]
        ys = y if dims[1] is not None else y[0]
        tops.reset_launches()
        got = _vmap(tops.matmul, xs, ys, in_dims=dims)
        assert tops.launch_counts()["matmul"] == 1
        for j in range(lanes):
            want = tops.matmul(xs[j] if dims[0] is not None else xs,
                               ys[j] if dims[1] is not None else ys)
            assert torch.equal(got[j], want), (lanes, m, k, n, dims, j)
    if dtype == "float32":
        x = _on_card(cuda_device, 3, (32, 64, 1024), dtype)
        tops.reset_launches()
        mean, msq = _vmap(tops.row_moments, x)
        assert tops.launch_counts()["row_moments"] == 1
        for j in range(32):
            wm, ws = tref.row_moments(x[j])
            torch.testing.assert_close(mean[j], wm, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(msq[j], ws, rtol=1e-4, atol=1e-5)
    for n, block in ((4096, 2048), (5000, 1024)):
        keys = to_torch(np_rand(4, (32, n), "uint32")).to(cuda_device)
        tops.reset_launches()
        got = _vmap(lambda v: tbs.bitonic_sort_blocks(v, block=block), keys)
        assert tops.launch_counts()["bitonic_sort"] == 1
        for j in range(32):
            assert torch.equal(got[j], tref.sort_blocks(
                keys[j], block, tbs.SENTINELS[keys.dtype]))


RMSNORM_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
               "bfloat16": dict(rtol=1e-2, atol=1e-2)}
FLASH_TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}


# (rows, D, base off the grid): the warp form at 16 lanes a row (D = 128
# in bf16) and a warp (512; 2560 in bf16); the scalar form for rows longer
# than the warp form takes (2560 in f32: a block holding its row; 20,000:
# read twice), the rows' bytes off the 16-byte grid (2558 in bf16, 130 in
# f32) and a base off the grid; rows that do not fill the last group
RMSNORM_CASES = [(8, 128, False), (33, 512, False), (7, 2560, False),
                 (5, 20_000, False), (9, 2558, False), (6, 130, False),
                 (33, 512, True), (1000, 128, False), (301, 2560, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain(cuda_device, dtype):
    # w in x's type and in the other one (the mixed forms rmsnorm.cu
    # compiles); every call of a case gives the same bits
    tops.reset_launches()
    calls = dict.fromkeys(trm.RMSNORM_FORMS, 0)
    for rows, d, off in RMSNORM_CASES:
        x = _on_card(cuda_device, 5, (rows, d), dtype, off)
        for w_dtype in ("float32", "bfloat16"):
            w = to_torch(np_rand(6, (d,), "float32"), w_dtype).to(cuda_device)
            got = tops.rmsnorm(x, w)
            torch.testing.assert_close(got.float(), tref.rmsnorm(x, w).float(),
                                       **RMSNORM_TOL[dtype])
            assert torch.equal(tops.rmsnorm(x, w), got)
            calls[trm.rmsnorm_form(x)] += 2
    assert tops.rmsnorm.forms == calls
    assert all(calls.values())  # every form ran


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype):
    # bf16 takes the wgmma form and f32 the tiled one (128 queries a block
    # each) at every width: 64, 128, 192 and 256, and 96, 80 (rows on the
    # 16-byte grid) and 100 (off it) padded to 128, 32 and 33 (odd) to
    # 64; ragged Skv; Sq below and above Skv under the causal mask; Sq
    # past two query tiles; Skv past Sq; bases off the 16-byte grid
    # (scalar loads)
    tops.reset_launches()
    calls = {"wgmma": 0, "tiled": 0}
    cases = [((2, 130, 4, 64), (2, 130, 4, 64), 0),
             ((1, 257, 2, 128), (1, 257, 2, 128), 0),
             ((1, 100, 2, 96), (1, 100, 2, 96), 0),
             ((2, 64, 4, 64), (2, 130, 4, 64), 0),
             ((1, 300, 2, 128), (1, 200, 2, 128), 0),
             ((1, 257, 2, 128), (1, 257, 2, 128), 1),
             ((2, 260, 2, 64), (2, 260, 2, 64), 0),
             ((1, 130, 2, 128), (1, 257, 2, 128), 0),
             ((1, 257, 2, 64), (1, 257, 2, 64), 1),
             ((1, 257, 2, 192), (1, 257, 2, 192), 0),
             ((1, 300, 2, 192), (1, 200, 2, 192), 0),
             ((1, 130, 2, 192), (1, 257, 2, 192), 1),
             ((1, 257, 2, 256), (1, 257, 2, 256), 0),
             ((1, 130, 2, 256), (1, 257, 2, 256), 0),
             ((1, 300, 2, 256), (1, 200, 2, 256), 0),
             ((1, 257, 2, 256), (1, 257, 2, 256), 1),
             ((2, 130, 4, 32), (2, 130, 4, 32), 0),
             ((1, 257, 2, 80), (1, 257, 2, 80), 0),
             ((1, 130, 2, 100), (1, 200, 2, 100), 0),
             ((1, 100, 2, 33), (1, 100, 2, 33), 0)]
    for qs, kvs, offset in cases:
        q, k, v = (to_torch(np_rand(seed, (offset + n,), "float32"), dtype)
                   .to(cuda_device)[offset:].view(shape)
                   for seed, shape, n in ((7, qs, math.prod(qs)),
                                          (8, kvs, math.prod(kvs)),
                                          (9, kvs, math.prod(kvs))))
        for causal in (True, False):
            torch.testing.assert_close(
                tops.flash_attention(q, k, v, causal=causal).float(),
                tref.flash_attention(q, k, v, causal).float(),
                **FLASH_TOL[dtype])
            calls[tfa.form(q)] += 1
    assert tops.flash_attention.forms == calls
    # bf16 took the tensor cores at every width, f32 the tiled form
    if dtype == "bfloat16":
        assert calls == {"wgmma": 2 * len(cases), "tiled": 0}
    else:
        assert calls == {"wgmma": 0, "tiled": 2 * len(cases)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_dispatch_matches_plain(cuda_device, dtype):
    # aligned one-tile shapes; C and D ragged across two tiles with 16-byte
    # rows and T not a multiple of the 64-token slab; C and D that rule
    # out vector loads; C one row past the f32 form's 256-row tile with D
    # off its 128 columns, and C, D past both on 16-byte rows.  bf16 x
    # runs the wgmma form, f32 x the SIMT one.
    tops.reset_launches()
    calls = 0
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    for t, e, c, d in [(64, 8, 16, 32), (128, 4, 64, 16), (200, 3, 136, 264),
                       (300, 5, 70, 130), (37, 3, 5, 24), (200, 3, 257, 130),
                       (64, 2, 260, 132)]:
        ids = torch.from_numpy(np_rand(10, (t,), "uint32") % e).to(
            torch.int64).to(cuda_device)
        x = to_torch(np_rand(11, (t, d), "float32"), dtype).to(cuda_device)
        for mask_dtype in ("float32", "bfloat16"):
            # one-hot: exact, with either mask type
            mask = tops.make_dispatch_mask(ids, e, c).to(
                getattr(torch, mask_dtype))
            assert torch.equal(tops.moe_dispatch(mask, x),
                               tref.moe_dispatch(mask, x))
            # dense masks in both types (the mixed forms moe_dispatch.cu
            # compiles); the op casts the mask to x's type first, as the
            # reference's kernel does, so the plain version gets it cast
            dense = to_torch(np_rand(12, (t, e, c), "float32"),
                             mask_dtype).to(cuda_device)
            torch.testing.assert_close(tops.moe_dispatch(dense, x).float(),
                                       tref.moe_dispatch(dense.to(x.dtype),
                                                         x).float(),
                                       **tol)
            calls += 2
    # base pointers off the 16-byte grid: scalar loads where the rows
    # alone would allow vectors
    t, e, c, d = 128, 4, 64, 16
    for mask_dtype in ("float32", "bfloat16"):
        buf = to_torch(np_rand(13, (t * e * c + 1,), "float32"),
                       mask_dtype).to(cuda_device)
        dense = buf[1:].view(t, e, c)
        xb = to_torch(np_rand(14, (t * d + 1,), "float32"),
                      dtype).to(cuda_device)[1:].view(t, d)
        torch.testing.assert_close(tops.moe_dispatch(dense, xb).float(),
                                   tref.moe_dispatch(dense.to(xb.dtype),
                                                     xb).float(),
                                   **tol)
        calls += 1
    form = "wgmma" if dtype == "bfloat16" else "simt"
    assert tops.moe_dispatch.forms == {f: calls if f == form else 0
                                       for f in ("wgmma", "simt")}


def _to(tree, device):
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: t.to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["alexnet", "inception_v3"])
def test_cuda_ai_steps_match_the_host_with_tf32_allowed(cuda_device, name):
    """The AI steps on the card against the host's, at the smallest batch,
    ``rtol=2e-4, atol=2e-5`` (``chip_smoke.py``'s ``AI_STEP_TOL``), with
    TF32 allowed around the card's call, so that a step that took it is
    caught.  Inception-V3 holds its average pool's backward, which
    torch 2.11 gets wrong on the card for channels-last inputs."""
    from repro_torch.workloads import WORKLOADS, inception_v3

    scale = {"alexnet": 8 / 128, "inception_v3": 4 / 32}[name]
    args = WORKLOADS[name].inputs(seed=0, scale=scale, device=cuda_device)
    step = WORKLOADS[name].step
    if name == "inception_v3":
        params, images, labels, rng = args
        keep = inception_v3.keep_mask(params, images, rng)
        step, args = inception_v3.step_with_keep, (params, images, labels,
                                                  keep)
    conv, matmul = (torch.backends.cudnn.allow_tf32,
                    torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        new, loss = step(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)
    hnew, hloss = step(*_to(args, "cpu"))
    torch.testing.assert_close(loss.cpu(), hloss, rtol=2e-4, atol=2e-5)
    for k in new:
        torch.testing.assert_close(new[k].cpu(), hnew[k], rtol=2e-4,
                                   atol=2e-5, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale", [("terasort", 0.01),
                                        ("pagerank", 0.02)])
def test_cuda_big_data_steps_match_the_host(cuda_device, name, scale):
    """TeraSort exact; PageRank's f32 sums in another order (atomics on
    the card) at ``rtol=1e-3, atol=1e-9`` (``chip_smoke.py``'s
    ``PAGERANK_TOL``), its in-degrees exact."""
    from repro_torch.uint32 import bits
    from repro_torch.workloads import WORKLOADS

    args = WORKLOADS[name].inputs(seed=0, scale=scale, device=cuda_device)
    got = WORKLOADS[name].step(*args)
    want = WORKLOADS[name].step(*_to(args, "cpu"))
    if name == "terasort":
        for g, w in zip(got, want):
            assert torch.equal(bits(g).cpu(), bits(w))
        return
    assert torch.equal(got[3].cpu(), want[3])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-9)


# -- wall times as captured CUDA graphs (core/signature.py) ------------------
#
# A replay must compute what an eager call computes on the same inputs:
# integers exactly; floats to rtol=1e-5, atol=1e-6, since index_add_'s f32
# atomics (PageRank, the graph and statistics motifs) land in another order
# on every run and cuBLAS may pick another algorithm on the capture's
# stream.

#: small P for one node of every motif variant (weight 2: the repeat loop)
CAPTURE_P = dict(data_size=1 << 12, chunk_size=64, num_tasks=2, batch_size=4,
                 height=8, width=8, channels=4, weight=2.0)
CAPTURE_VARIANTS = [(m, v) for m in sorted(MOTIFS) for v in MOTIFS[m].variants]
#: the steps at small scales; TeraSort's bincount sizes its output from the
#: data, a host read no capture allows
STEP_SCALES = {"kmeans": 0.05, "terasort": 0.01, "pagerank": 0.05,
               "alexnet": 8 / 128, "inception_v3": 4 / 32}


def _assert_replays_equal(got, want, what: str) -> None:
    from torch.utils._pytree import tree_leaves

    from repro_torch.uint32 import bits

    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        if not isinstance(w, torch.Tensor):
            continue
        if w.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6,
                                       msg=f"{what} leaf {i}")
        else:
            assert torch.equal(bits(g), bits(w)), f"{what} leaf {i}"


@pytest.mark.cuda
def test_cuda_captured_kmeans_step_replays_to_the_eager_outputs(cuda_device):
    from repro_torch.core.signature import CapturedGraph, timed_wall
    from repro_torch.workloads import WORKLOADS

    w = WORKLOADS["kmeans"]
    args = w.inputs(0, STEP_SCALES["kmeans"], device=cuda_device)
    want = w.step(*args)
    with CapturedGraph(lambda: w.step(*args), device=cuda_device) as graph:
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            _assert_replays_equal(graph.outputs, want, "kmeans step")
    seconds, timing = timed_wall(lambda: w.step(*args), device=cuda_device)
    assert timing == {"mode": "graph"} and seconds > 0


@pytest.mark.cuda
def test_cuda_a_host_read_is_not_captured_and_the_next_capture_works(
        cuda_device):
    from repro_torch.core.signature import (CapturedGraph, NotCaptured,
                                            timed_wall)
    from repro_torch.workloads import WORKLOADS

    ts = WORKLOADS["terasort"]
    targs = ts.inputs(0, STEP_SCALES["terasort"], device=cuda_device)
    for _ in range(2):
        with pytest.raises(NotCaptured, match="terasort.py"):
            CapturedGraph(lambda: ts.step(*targs), device=cuda_device)
        seconds, timing = timed_wall(lambda: ts.step(*targs),
                                     device=cuda_device)
        assert timing["mode"] == "eager" and seconds > 0
        assert timing["reason"].startswith("not captured: ")
        assert "terasort.py" in timing["reason"], timing
    # eager work and a later capture in the same process are unharmed
    x = torch.randn(4096, device=cuda_device)
    assert torch.isfinite(torch.sort(x).values.sum()).item()
    w = WORKLOADS["kmeans"]
    args = w.inputs(0, STEP_SCALES["kmeans"], device=cuda_device)
    want = w.step(*args)
    with CapturedGraph(lambda: w.step(*args), device=cuda_device) as graph:
        graph.replay()
        torch.cuda.synchronize()
        _assert_replays_equal(graph.outputs, want, "kmeans after a failure")


@pytest.mark.cuda
@pytest.mark.parametrize("failed", [False, True])
def test_cuda_a_closed_capture_gives_its_memory_back(cuda_device, failed):
    """A graph's pool goes back to the device once the graph is closed or
    its capture failed, so a run of captures does not pile up their pools
    and hold the card: after three captures of the step at full scale,
    less than half of the most the card held during them stays reserved
    (a reset alone kept all of it)."""
    from repro_torch.core.signature import CapturedGraph, NotCaptured
    from repro_torch.workloads import WORKLOADS

    name = "terasort" if failed else "kmeans"
    w = WORKLOADS[name]
    args = w.inputs(0, 1.0, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    before = torch.cuda.memory_reserved(cuda_device)
    for _ in range(3):
        if failed:
            with pytest.raises(NotCaptured):
                CapturedGraph(lambda: w.step(*args), device=cuda_device)
            continue
        with CapturedGraph(lambda: w.step(*args), device=cuda_device) as g:
            g.replay()
            torch.cuda.synchronize()
    held = torch.cuda.max_memory_reserved(cuda_device) - before
    kept = torch.cuda.memory_reserved(cuda_device) - before
    assert held > 0 and kept < held / 2, (kept, held)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STEP_SCALES))
def test_cuda_workload_steps_are_captured_but_terasorts(cuda_device, name):
    from repro_torch.core.signature import CapturedGraph, timed_wall
    from repro_torch.workloads import WORKLOADS

    w = WORKLOADS[name]
    args = w.inputs(0, STEP_SCALES[name], device=cuda_device)
    seconds, timing = timed_wall(lambda: w.step(*args), device=cuda_device)
    if name == "terasort":
        assert timing["mode"] == "eager" and "terasort.py" in \
            timing["reason"], timing
        return
    assert timing == {"mode": "graph"}, timing
    want = w.step(*args)
    with CapturedGraph(lambda: w.step(*args), device=cuda_device) as graph:
        graph.replay()
        torch.cuda.synchronize()
        _assert_replays_equal(graph.outputs, want, f"{name} step")


@pytest.mark.cuda
@pytest.mark.parametrize("substrate", ["torch", "hopper"])
@pytest.mark.parametrize("motif,variant", CAPTURE_VARIANTS)
def test_cuda_every_variant_eval_form_is_captured(cuda_device, motif,
                                                   variant, substrate):
    """Each variant's eval form (its inputs drawn inside, from generators
    the capture registers) replays to the eager run's outputs."""
    from repro_torch.core.motifs import PVector
    from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
    from repro_torch.core.signature import CapturedGraph, timed_wall

    p = PVector(substrate=substrate, **CAPTURE_P)
    pb = ProxyBenchmark("one", (MotifNode("n0", motif, variant, p),))
    fn, vals = pb.build_eval_fn(cuda_device), pb.lifted_values(cuda_device)
    want = fn(0, vals)
    with CapturedGraph(lambda: fn(0, vals), device=cuda_device) as graph:
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            _assert_replays_equal(graph.outputs, want, f"{motif}/{variant}")
    assert timed_wall(lambda: fn(0, vals), device=cuda_device)[1] == {
        "mode": "graph"}


@pytest.mark.cuda
def test_cuda_store_entries_record_graph_timing(cuda_device, tmp_path):
    """A captured engine's entry says it was captured; one rewritten as
    the eager-timing store version wrote it is a miss."""
    import json

    from repro_torch.core import EvalSession, ProxyStore
    from repro_torch.core.motifs import PVector
    from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
    from repro_torch.core.store import (_payload_checksum, canonical_key,
                                        key_digest)

    pb = ProxyBenchmark("one", (MotifNode(
        "n0", "sort", "quick", PVector(substrate="hopper", **CAPTURE_P)),))
    session = EvalSession(run=True, seed=0, device=cuda_device,
                          store=ProxyStore(str(tmp_path)))
    session.evaluate(pb)
    assert session.signature_of(pb).timing == {"mode": "graph"}
    key = session.cache.store_key(session.cache.key_for(pb))
    path = session.store._sig_path(key_digest(canonical_key(key)))
    with open(path) as f:
        doc = json.load(f)
    assert doc["payload"]["signature"]["timing"] == {"mode": "graph"}
    doc["version"] = 1
    del doc["payload"]["signature"]["timing"]
    doc["checksum"] = _payload_checksum(doc["payload"])
    with open(path, "w") as f:
        json.dump(doc, f)
    fresh = EvalSession(run=True, seed=0, device=cuda_device,
                        store=ProxyStore(str(tmp_path)))
    fresh.evaluate(pb)
    assert (fresh.stats()["compiles"], fresh.stats()["store_invalid"]) == (
        1, 1)
    assert fresh.signature_of(pb).timing == {"mode": "graph"}
