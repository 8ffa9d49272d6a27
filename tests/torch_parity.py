"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the port compute on the same values.  Not a test module:
pytest does not collect it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the suite runs with several pytest-xdist workers on a few cores
torch.set_num_threads(1)


def np_rand(seed: int, shape, dtype: str) -> np.ndarray:
    """Random numpy data: uint32/int32 words or standard-normal floats.
    ``bfloat16`` comes back as float32; cast it in each package."""
    rng = np.random.default_rng(seed)
    if dtype in ("uint32", "int32"):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
            np.uint32).view(dtype)
    return rng.standard_normal(shape).astype(np.float32)


def to_torch(a: np.ndarray, dtype: str = "") -> torch.Tensor:
    """A CPU tensor of ``a`` (cast to ``dtype`` when given)."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(getattr(torch, dtype)) if dtype else t


def to_jax(a: np.ndarray, dtype: str = ""):
    import jax.numpy as jnp

    return jnp.asarray(a, getattr(jnp, dtype)) if dtype else jnp.asarray(a)


def as_np(x) -> np.ndarray:
    """numpy view of a jax array or tensor; bfloat16 widened to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def torch_tree_to_jax(tree: dict) -> dict:
    """The same values as JAX arrays, dtypes kept (bfloat16 included)."""
    return {k: to_jax(as_np(t), str(t.dtype).replace("torch.", ""))
            for k, t in tree.items()}


def tree_structure(tree: dict) -> dict:
    """key -> (shape, dtype name) of a dict of tensors or (abstract) arrays."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def assert_trees_close(want, got, rtol: float, atol: float) -> None:
    """Every leaf of a reference output dict against the port's, by key."""
    assert set(want) == set(got), (sorted(want), sorted(got))
    for k in want:
        w, g = as_np(want[k]), as_np(got[k])
        assert w.shape == g.shape, (k, w.shape, g.shape)
        if rtol == 0 and atol == 0:
            np.testing.assert_array_equal(w, g, err_msg=k)
        else:
            np.testing.assert_allclose(w.astype(np.float64),
                                       g.astype(np.float64), rtol=rtol,
                                       atol=atol, err_msg=k)


class KernelOps(TorchDispatchMode):
    """Records the names of the ``repro_torch`` kernel ops a run calls
    (their plain versions, on CPU tensors)."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.ops.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def cuda_device() -> torch.device:
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never while the test module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU "
                    "(python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the model zoo: one config in both packages, the same weights
# ---------------------------------------------------------------------------

#: the configs the port builds; the other five raise NotImplementedError
ZOO_BUILDABLE = ("qwen3-4b", "tinyllama-1.1b", "mistral-nemo-12b",
                 "gemma2-9b", "internvl2-1b")
ZOO_UNPORTED = ("deepseek-v2-lite-16b", "deepseek-v3-671b", "mamba2-780m",
                "recurrentgemma-9b", "whisper-small")


def zoo_pair(name: str, dtype: str = "float32", *, layers: int = 2,
             seed: int = 0, **overrides):
    """``reduced(get_config(name), layers=layers)`` at compute ``dtype`` in
    both packages, built, with the reference's weights from ``seed``
    handed to the port: ``(ref_model, ref_params, port_model,
    port_params)``."""
    import jax

    from repro.configs import get_config as ref_get, reduced as ref_reduced
    from repro.models import build_model as ref_build
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import model_params_from_reference
    from repro_torch.models import build_model

    rcfg = ref_reduced(ref_get(name), layers=layers).replace(
        dtype=dtype, **overrides)
    cfg = reduced(get_config(name), layers=layers).replace(
        dtype=dtype, **overrides)
    rm, m = ref_build(rcfg), build_model(cfg)
    rp = rm.init(jax.random.key(seed))
    return rm, rp, m, model_params_from_reference(jax_tree_to_numpy(rp),
                                                  "cpu")


def flat(tree, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def bf16_tol(want) -> dict:
    """The bf16 tolerance of the zoo's parity tests: ``rtol`` one bf16
    rounding (2^-7) and ``atol`` a tenth of the reference output's
    standard deviation.  Measured on the reduced configs (two layers, seed
    0): the port's forward, prefill, cache and decode outputs lie within
    4.6 % of that deviation of the reference's; each product and norm
    rounds to bf16 in both packages, at sums taken in another order."""
    return dict(rtol=2.0 ** -7, atol=0.1 * float(np.std(as_np(want))))


#: the f32 tolerance of the zoo's parity tests (measured: 4e-6 at most)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def zoo_tol(dtype: str, want) -> dict:
    return F32_TOL if dtype == "float32" else bf16_tol(want)
