"""The port's six kernel ops as the dispatcher and a profile see them.

Each kernel is one op of the ``repro_torch`` namespace, registered with
``torch.library.Library`` (``kernels/_build.py::define_op``) on the CPU
and CUDA keys.  On the CPU each op runs its plain version, so its result
equals ``kernels/ref.py``'s exactly; it rejects what its kernel does not
take; and a signature profile of one call counts one op of the class
``core/signature.py::KERNEL_OPS`` gives it.  The forms the CUDA wrappers
pick (``matmul.form``, ``rmsnorm.form``) are checked against the rules
the kernels' sources state.
"""
import re

import pytest
import torch

from torch_parity import np_rand, to_torch

from repro_torch.bench import split_tiles
from repro_torch.core.signature import KERNEL_OPS, profile_call
from repro_torch.kernels import _build
from repro_torch.kernels import bitonic_sort as tbs
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trm


def _t(seed, shape, dtype="float32"):
    return to_torch(np_rand(seed, shape, "float32"), dtype)


def _cases():
    """(op name, args, plain version's result) on small CPU inputs."""
    x, y = _t(1, (33, 20)), _t(2, (20, 7))
    r = _t(3, (5, 70))
    w = _t(4, (70,))
    q, k, v = (_t(s, (1, 9, 2, 8)) for s in (5, 6, 7))
    mask = tops.make_dispatch_mask(torch.arange(12) % 3, 3, 4)
    xd = _t(8, (12, 6))
    keys = to_torch(np_rand(9, (100,), "uint32"))
    return {
        "matmul": ((x, y), tref.matmul(x, y)),
        "row_moments": ((r,), tref.row_moments(r)),
        "rmsnorm": ((r, w, 1e-6), tref.rmsnorm(r, w, 1e-6)),
        "bitonic_sort_blocks": (
            (keys, 32),
            tref.sort_blocks(keys, 32, tbs.sort_sentinel(keys.dtype).item())),
        "flash_attention": ((q, k, v, True), tref.flash_attention(q, k, v)),
        "moe_dispatch": ((mask, xd), tref.moe_dispatch(mask, xd)),
    }


OPS = sorted(KERNEL_OPS)


def test_every_kernel_op_is_registered_once():
    assert OPS == sorted(_cases())
    assert OPS == sorted(k.wrapper.__name__ for k in tops.KERNELS.values())


@pytest.mark.parametrize("name", OPS)
def test_op_is_reachable_through_torch_ops(name):
    packet = getattr(torch.ops.repro_torch, name)
    assert packet.default._schema.name == f"repro_torch::{name}"
    # defined with the Library form on the CPU and CUDA keys
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            f"repro_torch::{name}", key)


@pytest.mark.parametrize("name", OPS)
def test_op_on_the_cpu_equals_the_plain_version(name):
    args, want = _cases()[name]
    got = getattr(torch.ops.repro_torch, name)(*args)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", OPS)
def test_a_profile_counts_one_op_of_its_class(name):
    args, _ = _cases()[name]
    op = getattr(torch.ops.repro_torch, name)
    sig = profile_call(lambda *a: op(*a), *args)
    assert sig.raw_cost == {f"ops_{KERNEL_OPS[name]}": 1.0}


def _rejections():
    x = torch.randn(8, 4)
    r = torch.randn(5, 8)
    q = torch.randn(1, 4, 2, 8)
    return [
        ("matmul", (x, torch.randn(3, 4).T), ValueError, "contiguous"),
        ("matmul", (x, torch.randn(4, 3, dtype=torch.float64)), TypeError, None),
        ("matmul", (x, torch.randn(5, 3)), ValueError, "K"),
        ("row_moments", (torch.randn(4, 8).T,), ValueError, "contiguous"),
        ("row_moments", (torch.randn(4, 8, dtype=torch.float64),), TypeError,
         None),
        ("row_moments", (torch.randn(4, 0),), ValueError, "non-empty"),
        ("rmsnorm", (r, torch.randn(7), 1e-6), ValueError, "w of shape"),
        ("rmsnorm", (r.T, torch.randn(5), 1e-6), ValueError, "contiguous"),
        ("bitonic_sort_blocks", (torch.arange(8, dtype=torch.int64), 4),
         TypeError, None),
        ("bitonic_sort_blocks", (torch.randn(8), 3), ValueError, "power"),
        ("flash_attention", (q, q, q[..., :4].contiguous(), True), ValueError,
         None),
        ("flash_attention", (torch.randn(1, 4, 2, 300),) * 3 + (True,),
         ValueError, "head widths"),
        ("moe_dispatch", (torch.ones(6, 2), torch.randn(6, 4)), ValueError,
         "mask"),
        ("moe_dispatch", (torch.ones(6, 2, 3), torch.randn(4, 6).T),
         ValueError, "contiguous"),
    ]


@pytest.mark.parametrize("case", range(len(_rejections())))
def test_op_rejects_what_its_kernel_does_not_take(case):
    name, args, exc, match = _rejections()[case]
    with pytest.raises(exc, match=match):
        getattr(torch.ops.repro_torch, name)(*args)


def test_a_second_definition_of_an_op_is_refused():
    with pytest.raises(RuntimeError):
        _build.define_op("matmul(Tensor x, Tensor y) -> Tensor", tref.matmul)


@pytest.mark.parametrize("m,k,n,form", [
    (64, 8, 1, "narrow"), (64, 8, 16, "narrow"), (64, 8, 17, "wide"),
    (12288, 8, 32, "wide"), (65536, 8, 2, "narrow"),
    (65536, 8, 32, "narrow"), (65536, 8, 33, "wide"),
    (12288, 8, 128, "wide"),
    (64, 67, 8, "wide"),          # rows off the 16-byte grid
])
def test_matmul_form_follows_the_narrow_bounds(m, k, n, form):
    assert tmm.form(torch.empty(m, k), torch.empty(k, n)) == form
    off_grid = torch.empty(m * k + 1)[1:].view(m, k)
    assert tmm.form(off_grid, torch.empty(k, n)) == "wide"


def test_matmul_narrow_bounds_match_the_source():
    src = (_build.CSRC / "matmul.cu").read_text()
    for name, want in (("MAX_N", tmm.NARROW_N),
                       ("SMALL_M_N", tmm.NARROW_SMALL_M_N)):
        found = re.search(rf"constexpr long long {name} = (\d+);", src)
        assert found and int(found.group(1)) == want
    found = re.search(r"constexpr long long FULL_M = BM \* (\d+);", src)
    assert found and 256 * int(found.group(1)) == tmm.NARROW_FULL_M


@pytest.mark.parametrize("m,k,n,form,slices", [
    (32, 2048, 2048, "split", 8),   # the AI proxies' fully_connected
    (1, 2048, 2048, "split", 8),
    (17, 2048, 2048, "split", 8),
    (64, 2048, 2048, "split", 6),   # two row tiles
    (128, 2048, 2048, "split", 3),  # four
    (129, 2048, 2048, "wide", 2),   # past the split form's rows
    (32, 512, 2048, "split", 2),    # K for two slices at the least
    (32, 511, 2048, "wide", 1),
    (32, 2048, 12672, "split", 2),  # 198 tiles: two slices of each
    (32, 2048, 12673, "wide", 1),
    (32, 2050, 2047, "split", 8),   # N and K off the 16-byte unit
    (8192, 2048, 128, "wide", 1),   # K-means' shapes keep their forms
    (12288, 2048, 128, "wide", 1),
    (32768, 2048, 128, "wide", 1),
    (4096, 64, 32, "wide", 1),
    (64, 512, 16, "narrow", 2),     # a narrow N takes the narrow form
    (32, 2048, 8, "narrow", 8),
])
def test_matmul_split_form_for_few_rows_and_long_k(m, k, n, form, slices):
    assert tmm.split_slices(m, n, k) == slices
    assert tmm.form(torch.empty(m, k), torch.empty(k, n)) == form
    # the split form takes rows off the 16-byte grid too; a narrow N there
    # goes to it where K cuts, else to the wide form
    off_grid = torch.empty(m * k + 1)[1:].view(m, k)
    want = "split" if m <= tmm.SPLIT_MAX_M and slices > 1 else "wide"
    assert tmm.form(off_grid, torch.empty(k, n)) == want


@pytest.mark.parametrize("m,k,n", [
    (64, 8, 1), (64, 8, 17), (12288, 8, 32), (65536, 8, 33), (64, 67, 8),
    (1000, 512, 16), (1000, 512, 17), (4099, 67, 8)])
def test_matmul_narrow_cases_never_split(m, k, n):
    assert tmm.form(torch.empty(m, k), torch.empty(k, n)) != "split"


def test_matmul_split_bounds_match_the_source():
    src = (_build.CSRC / "matmul.cu").read_text()
    split = src.split("namespace split {", 1)[1].split("}  // namespace split",
                                                      1)[0]
    for name, want in (("MAX_M", tmm.SPLIT_MAX_M),
                       ("MIN_K", tmm.SPLIT_MIN_K),
                       ("MAX_SLICES", tmm.SPLIT_MAX_SLICES)):
        found = re.search(rf"constexpr long long {name} = (\d+);", split)
        assert found and int(found.group(1)) == want, name
    found = re.search(r"constexpr long long BLOCKS = (\d+) \* (\d+);", split)
    assert found and int(found.group(1)) * int(found.group(2)) == \
        tmm.SPLIT_BLOCKS
    tile = tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               split).group(1)) for name in ("BM", "BN"))
    assert tile == tmm.SPLIT_TILE
    # the form codes the wrapper passes are the launch's
    launch = src.split("int launch(int form,", 1)[1]
    assert "form == 3)\n    return vec ? split::launch" in launch
    assert "form == 2) {" in launch and "if (form != 1) return -1;" in launch
    assert tmm.FORM_CODES == {"auto": 0, "wide": 1, "narrow": 2, "split": 3}
    assert set(tmm.FORMS) == set(tmm.FORM_CODES) - {"auto"}


@pytest.mark.parametrize("lanes,m,k,n,fold", [
    (4, 32, 2048, 2048, False),   # each lane splits K: the lane axis
    (3, 64, 2048, 2048, False),   # folded, 192 rows would go wide
    (4, 300, 64, 128, True),      # the wide form sums in k order: folds
    (4, 16, 64, 8, True),         # the narrow form likewise
    (4, 8, 300, 2048, True),      # one slice a lane: wide, as the fold
    (3, 33, 64, 24, True),
])
def test_matmul_vmap_folds_lanes_of_x_unless_they_split(monkeypatch, lanes,
                                                        m, k, n, fold):
    from repro_torch.core.evaluator import no_vmap_fallback

    x, y = _t(11, (lanes, m, k)), _t(12, (k, n))
    assert tmm.folds(x, y) == fold
    assert (tmm.form(x[0], y) == "split") == (not fold)
    if not fold:  # folded, the product would take another form
        assert tmm.form(x.reshape(lanes * m, k), y) != "split" or (
            tmm.split_slices(lanes * m, n, k) != tmm.split_slices(m, n, k))
    seen = []
    lanes_fn = tmm.matmul_lanes
    monkeypatch.setattr(tmm, "matmul_lanes",
                        lambda a, b: seen.append(a.shape) or lanes_fn(a, b))
    with no_vmap_fallback():
        got = torch.func.vmap(tops.matmul, in_dims=(0, None))(x, y)
    # folded: the op once on (L·M, K); else one lane-axis call on (L, M, K)
    assert seen == ([(lanes * m, k)] if fold else [(lanes, m, k)])
    # (bit-equal lanes are the kernel's property: the cuda tests hold it)
    for j in range(lanes):
        torch.testing.assert_close(got[j], tref.matmul(x[j], y), rtol=1e-5,
                                   atol=1e-4)


D_ONE = trm.ONE_LAUNCH_BYTES // 16       # four f32 rows of this length
D_ROW = trm.ONE_LAUNCH_ROW_BYTES // 4    # one f32 row of this length


@pytest.mark.parametrize("rows,d,itemsize,form", [
    (1024, 57, 4, "one_launch"),            # the main path's shape
    (4, D_ONE, 4, "one_launch"),            # the input's bound
    (4, D_ONE + 1, 4, "split"),
    (16, D_ROW, 4, "one_launch"),           # the row's bound
    (16, D_ROW + 1, 4, "split"),
    (33, 70_001, 4, "one_launch"),
    (33, 1 << 18, 2, "one_launch"),
    (33, 1 << 19, 2, "split"),
    (64, 1 << 22, 4, "split"),
    (300, 1 << 20, 4, "one_launch"),        # rows enough to fill the card
])
def test_row_moments_form_and_splits(rows, d, itemsize, form):
    splits = trm.splits_for(rows, d, itemsize)
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    assert trm.form(torch.empty(rows, d, dtype=dtype)) == form
    assert (splits == 1) == (form == "one_launch")
    if form == "split":
        # one wave of pass-1 blocks, never a segment below MIN_SEGMENT
        assert rows * splits <= trm.TARGET_BLOCKS
        assert d // splits >= trm.MIN_SEGMENT


@pytest.mark.parametrize("rows,d,dtype,form", [
    (32768, 2560, torch.bfloat16, "warp"),    # qwen3-4b's d_model: a warp
    (32768, 128, torch.bfloat16, "warp"),     # its qk-norm: 16 lanes a row
    (8, 8 * trm.WARP_UNITS, torch.bfloat16, "warp"),  # the warp form's bound
    (8, 8 * trm.WARP_UNITS + 8, torch.bfloat16, "scalar"),  # one unit more
    (32768, 2560, torch.float32, "scalar"),   # 640 units: a block a row
    (5, 20_000, torch.bfloat16, "scalar"),    # read twice
    (7, 2558, torch.bfloat16, "scalar"),      # row bytes off the 16-byte grid
    (8, 130, torch.float32, "scalar"),
])
def test_rmsnorm_form_follows_the_row_bytes(rows, d, dtype, form):
    x = torch.empty(rows, d, dtype=dtype)
    assert trm.rmsnorm_form(x) == form
    assert tops.rmsnorm.form(x, torch.empty(d)) == form
    # a base one element past the 16-byte grid takes scalar loads
    off = torch.empty(rows * d + 1, dtype=dtype)[1:].view(rows, d)
    assert trm.rmsnorm_form(off) == "scalar"


def test_rmsnorm_warp_bound_matches_the_source():
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    found = re.search(r"constexpr long long WARP_UNITS = 32 \* (\d+);", src)
    assert found and 32 * int(found.group(1)) == trm.WARP_UNITS


def test_rmsnorm_on_the_cpu_counts_no_form():
    tops.reset_launches()
    tops.rmsnorm(torch.randn(4, 128), torch.randn(128))
    assert tops.rmsnorm.forms == dict.fromkeys(trm.RMSNORM_FORMS, 0)
    assert tops.launch_counts()["rmsnorm"] == 0


@pytest.mark.parametrize("name", sorted(split_tiles.VARIANTS))
def test_split_variants_change_only_their_constants(name):
    # each copy repro_torch.bench.split_tiles times differs from the tree
    # in the split namespace's constant lines it names, and nowhere else
    src = (_build.CSRC / "matmul.cu").read_text()
    change = split_tiles.VARIANTS[name]
    got = split_tiles.variant_source(src, change)
    changed = [(a, b) for a, b in zip(src.splitlines(), got.splitlines())
               if a != b]
    assert len(got.splitlines()) == len(src.splitlines())
    split = src.split("namespace split {")[1].split("}  // namespace split")[0]
    want = []
    for line in split.splitlines():
        for const, value in change.items():
            m = re.match(rf"(constexpr (?:int|long long) {const} = )([^;]*);",
                         line)
            if m and m.group(2) != str(value):
                want.append((line, line.replace(m.group(0),
                                                f"{m.group(1)}{value};", 1)))
    assert changed == want
    assert bool(changed) == bool(change)


def test_split_variants_refuse_a_constant_the_source_lacks():
    src = (_build.CSRC / "matmul.cu").read_text()
    with pytest.raises(ValueError, match="NO_SUCH"):
        split_tiles.variant_source(src, {"NO_SUCH": 3})
    # STAGES is also a constant of the narrow form: only the split one moves
    got = split_tiles.variant_source(src, {"STAGES": 3})
    assert got.split("namespace split {")[0] == src.split(
        "namespace split {")[0]


def test_split_bench_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        split_tiles.main()
