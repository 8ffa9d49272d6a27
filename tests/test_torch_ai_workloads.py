"""AlexNet and Inception-V3 in the port against the JAX package, on the
same inputs, and the params converter between them.

Params, images and labels are numpy arrays made from a seed; the
reference takes conv kernels HWIO, the port OIHW
(``repro_torch.convert.params_from_reference`` and its inverse).  Each
step is forward, backward and SGD; its loss and new params are held at
``rtol=1e-4, atol=1e-5`` (f32 products and sums in another order), at
the smallest batch ``make_inputs`` allows.  Inception-V3's head dropout
takes the reference's own keep mask, ``jax.random.bernoulli(rng, 0.8,
shape)``.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import KernelOps, as_np, np_rand, to_jax, to_torch

from repro.workloads import WORKLOADS as JWORKLOADS
from repro_torch.convert import params_from_reference, params_to_reference
from repro_torch.core.generator import _check_args_device, generate_proxy
from repro_torch.core.motifs import PVector
from repro_torch.data.generators import generator_from
from repro_torch.device import full_f32
from repro_torch.workloads import WORKLOADS, alexnet, inception_v3

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
#: the smallest batch each make_inputs allows, and the scale that gives it
SMALL = {"alexnet": (8, 8 / 128), "inception_v3": (4, 4 / 32)}
MODULES = {"alexnet": alexnet, "inception_v3": inception_v3}


def _np_params(name, seed):
    """Reference-layout numpy params: the port's initialiser from a seed,
    carried to HWIO."""
    gen = torch.Generator().manual_seed(seed)
    return params_to_reference(MODULES[name].init_params(gen))


def _batch(name, seed):
    mod = MODULES[name]
    batch = SMALL[name][0]
    images = np_rand(seed, (batch, mod.IMG, mod.IMG, 3), "float32")
    labels = np.random.default_rng(seed).integers(
        0, mod.NUM_CLASSES, batch).astype(np.int32)
    return images, labels


def _compare_step(want, got):
    (jnew, jloss), (tnew, tloss) = want, got
    np.testing.assert_allclose(as_np(tloss), np.asarray(jloss), **STEP_TOL)
    back = params_to_reference(tnew)
    assert set(back) == set(jnew)  # jax returns dicts key-sorted
    for k in jnew:
        assert back[k].shape == np.asarray(jnew[k]).shape, k
        np.testing.assert_allclose(back[k], np.asarray(jnew[k]), err_msg=k,
                                   **STEP_TOL)


def test_alexnet_step_matches_reference():
    params = _np_params("alexnet", 1)
    images, labels = _batch("alexnet", 2)
    want = jax.jit(JWORKLOADS["alexnet"].step)(
        {k: to_jax(v) for k, v in params.items()}, to_jax(images),
        to_jax(labels))
    got = WORKLOADS["alexnet"].step(params_from_reference(params, "cpu"),
                                    to_torch(images), to_torch(labels))
    _compare_step(want, got)


def test_inception_v3_step_matches_reference_with_its_keep_mask():
    params = _np_params("inception_v3", 3)
    images, labels = _batch("inception_v3", 4)
    rng = jax.random.key(5)
    keep = np.asarray(jax.random.bernoulli(
        rng, inception_v3.KEEP, (images.shape[0], params["fc"].shape[0])))
    assert 0 < keep.mean() < 1
    want = jax.jit(JWORKLOADS["inception_v3"].step)(
        {k: to_jax(v) for k, v in params.items()}, to_jax(images),
        to_jax(labels), rng)
    got = inception_v3.step_with_keep(params_from_reference(params, "cpu"),
                                      to_torch(images), to_torch(labels),
                                      to_torch(keep))
    _compare_step(want, got)


def test_inception_v3_step_draws_its_keep_mask_from_the_seed():
    params, images, labels, rng = WORKLOADS["inception_v3"].inputs(
        seed=0, scale=SMALL["inception_v3"][1], device="cpu")
    assert rng.shape == () and rng.dtype == torch.int32
    gen = generator_from(rng)
    keep = torch.rand((images.shape[0], inception_v3.head_width(params)),
                      generator=gen) < inception_v3.KEEP
    new, loss = inception_v3.step(params, images, labels, rng)
    new2, loss2 = inception_v3.step_with_keep(params, images, labels, keep)
    assert torch.equal(loss, loss2) and torch.isfinite(loss)
    for k in new:
        assert torch.equal(new[k], new2[k]), k


@pytest.mark.parametrize("name", ["alexnet", "inception_v3"])
def test_inputs_match_the_reference_configuration(name):
    batch, scale = SMALL[name]
    got = WORKLOADS[name].inputs(seed=0, scale=scale, device="cpu")
    want = jax.eval_shape(lambda k: JWORKLOADS[name].inputs(k, scale),
                          jax.random.key(0))
    assert len(got) == len(want)
    params = params_to_reference(got[0])
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in want[0].items()}
    assert all(v.dtype == np.float32 for v in params.values())
    for g, w in zip(got[1:3], want[1:3]):  # images, labels
        assert (tuple(g.shape), str(g.dtype)[6:]) == (w.shape, str(w.dtype))
    assert got[1].shape[0] == batch
    if name == "inception_v3":  # the PRNG key leaf is a 0-d int32 seed
        assert jax.dtypes.issubdtype(want[3].dtype, jax.dtypes.prng_key)
        assert got[3].shape == () and got[3].dtype == torch.int32


@pytest.mark.parametrize("name", ["alexnet", "inception_v3"])
def test_params_converter_round_trips(name):
    params = _np_params(name, 7)
    port = params_from_reference(params, "cpu")
    for k, v in params.items():
        if v.ndim == 4:  # HWIO -> OIHW
            assert tuple(port[k].shape) == (v.shape[3], v.shape[2],
                                            v.shape[0], v.shape[1])
            np.testing.assert_array_equal(as_np(port[k][2, 1]),
                                          v[:, :, 1, 2])
        else:
            np.testing.assert_array_equal(as_np(port[k]), v)
    back = params_to_reference(port)
    assert list(back) == list(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])


def test_argument_device_check_walks_nested_params():
    nested = ({"conv1": torch.zeros(2), "deep": [torch.ones(1)]},
              torch.zeros(3))
    with pytest.raises(ValueError, match="cpu"):
        _check_args_device(nested, torch.device("meta"))
    with pytest.raises(ValueError, match="cpu"):
        _check_args_device(({"w": torch.zeros(2)},), torch.device("meta"))
    _check_args_device(nested, torch.device("cpu"))


class _Precision(TorchDispatchMode):
    """The TF32 flags each product and convolution ran under."""

    def __init__(self):
        super().__init__()
        self.flags = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("convolution",
                                            "convolution_backward", "mm",
                                            "addmm", "bmm"):
            self.flags.add((torch.backends.cudnn.allow_tf32,
                            torch.get_float32_matmul_precision()))
        return func(*args, **(kwargs or {}))


def _matrix_variants():
    from repro_torch.core.motifs import get_motif

    motif, p = get_motif("matrix"), PVector(data_size=2048, chunk_size=64)
    inputs = motif.make_inputs(p, 0, "cpu")
    for v in ("euclidean", "cosine", "matmul", "fully_connected"):
        motif.apply(p, inputs, v)


def _step(name):
    scale = SMALL.get(name, (0, 0.005))[1]
    args = WORKLOADS[name].inputs(seed=0, scale=scale, device="cpu")
    return lambda: WORKLOADS[name].step(*args)


@pytest.mark.parametrize("name", ["alexnet", "inception_v3", "kmeans",
                                  "matrix"])
def test_products_run_in_full_f32_whatever_the_global_flags(name):
    run = _matrix_variants if name == "matrix" else _step(name)
    conv, matmul = (torch.backends.cudnn.allow_tf32,
                    torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        with _Precision() as seen:
            run()
        assert seen.flags == {(False, "highest")}
        # the caller's flags come back
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
        with pytest.raises(RuntimeError, match="boom"):
            with full_f32():
                raise RuntimeError("boom")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)


@pytest.mark.parametrize("name", ["alexnet", "inception_v3"])
def test_generate_proxy_end_to_end(name):
    w = WORKLOADS[name]
    args = w.inputs(seed=0, scale=SMALL[name][1], device="cpu")
    pb, rep = generate_proxy(
        w.step, *args, name=name, hints=w.hints,
        base_p=PVector(data_size=2 ** 11, chunk_size=64, num_tasks=2,
                       batch_size=2, height=8, width=8, channels=4),
        max_iters=2, run=False, substrate="hopper", device="cpu")
    pb.validate()
    assert [(n.motif, n.variant) for n in pb.nodes] == [
        (h.motif, h.variant) for h in w.hints]
    assert {n.p.substrate for n in pb.nodes} == {"hopper"}
    assert 0.0 <= rep.mean_accuracy <= 1.0 and rep.iterations <= 2
    assert rep.target_metrics["mix_conv"] > 0.02
    # fully_connected and batchnorm reach the kernels (plain on the CPU)
    with KernelOps() as seen:
        pb.build_eval_fn("cpu")(0, pb.lifted_values("cpu"))
    assert seen.ops == {"matmul", "row_moments"}
