"""Data-parallel ``launch.train.train`` over gloo ranks on the CPU, held
against one rank's run of the same steps.

``train`` runs a reduced qwen3-4b (2 layers, d_model 160, 2 heads, one KV
head, vocab 9496; f32 compute) for 6 steps of 4 x 32 tokens over 2 and
4 ranks, at
model axis 1 (params replicated, the batch on ``data``, the moments'
ZeRO-1 split over ``data``) and at model axis 2 (the heads, the MLP and
the vocabulary split over ``model`` as well).  Each rank's losses and
the final params (gathered whole) equal the
one-rank run's within ``rtol=atol=1e-4``: the gradients are the same
sums in another order.  A fault injected on every rank at the step after a
checkpoint recovers, through each rank's checkpoint, to the same losses
as the run without it.  deepseek-v2-lite-16b reduced the same way (MLA,
four experts over ``model``, 4 steps) trains over 2 and 4 ranks at model
axis 2 to the one-rank run's losses and params, within the same
tolerance.  These replace the test of the refusal that data-parallel
training used to raise."""
from __future__ import annotations

import numpy as np
import pytest
import torch_parity  # noqa: F401  (one torch thread a test worker)
import torch_train_ranks

from repro_torch.distributed.launch import spawn
from repro_torch.launch.train import train
from repro_torch.models.params import tree_leaves

ARCH = "qwen3-4b"
KW = dict(steps=6, batch=4, seq=32, reduce=16, lr=3e-3, device="cpu",
          log_every=0, ckpt_every=2, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


MOE = "deepseek-v2-lite-16b"
MOE_KW = dict(KW, steps=4)


def _one_rank(arch, kw, tmp):
    out = train(arch, ckpt_dir=str(tmp), **kw)
    return out["losses"], [x.numpy()
                           for x in tree_leaves(out["state"]["params"])]


def _held(arch, kw, want, ranks, model_axis, tmp_path):
    losses, params = want
    outs = spawn(torch_train_ranks.train_rank, ranks, arch,
                 dict(kw, model_axis=model_axis, ckpt_dir=str(tmp_path)),
                 timeout_s=300)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], losses, **TOL,
                                   err_msg=f"rank {r}")
    got = outs[0]["params_whole"]
    assert len(got) == len(params)
    for g, w in zip(got, params):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _one_rank(ARCH, KW, tmp_path_factory.mktemp("one"))


@pytest.fixture(scope="module")
def one_rank_moe(tmp_path_factory):
    return _one_rank(MOE, MOE_KW, tmp_path_factory.mktemp("one_moe"))


@pytest.mark.parametrize("ranks,model_axis", [(2, 1), (2, 2), (4, 1),
                                              (4, 2)])
def test_data_parallel_train_matches_one_rank(ranks, model_axis, one_rank,
                                              tmp_path):
    _held(ARCH, KW, one_rank, ranks, model_axis, tmp_path)


@pytest.mark.parametrize("ranks", [2, 4])
def test_moe_mla_data_parallel_train_matches_one_rank(ranks, one_rank_moe,
                                                      tmp_path):
    _held(MOE, MOE_KW, one_rank_moe, ranks, 2, tmp_path)


def test_a_fault_on_every_rank_recovers_to_the_same_losses(one_rank,
                                                           tmp_path):
    losses, _ = one_rank
    # step 3's checkpoint is the last good one when step 4 fails
    outs = spawn(torch_train_ranks.train_rank, 2, ARCH,
                 dict(KW, model_axis=2, ckpt_dir=str(tmp_path)), 4,
                 timeout_s=300)
    for out in outs:
        assert out["recoveries"] == 1
        np.testing.assert_allclose(out["losses"], losses, **TOL)
