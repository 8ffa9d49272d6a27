"""The zoo's DTensor paths on real values, over gloo ranks on the CPU,
held against the plain one-rank path (which the other tests hold to the
JAX package) at ``rtol=atol=1e-4`` in f32.

The dry run profiles these paths on shape-only tensors, where nothing is
computed; here they compute.  Over 2 ranks (mesh (1, 2): everything the
rule table maps to ``model`` split in two) and 4 ranks (mesh (2, 2): the
batch split over ``data`` as well):

* ``layers.decode_attention`` on a cache split by position (split-K: the
  softmax's max and sum and the weighted values reduced over ``model``),
  over the whole cache, over a window's slice of a linear cache, and
  over a ring with explicit positions, at every index of a 16-position
  cache; and ``spmd.index_copy_`` writing each slot in turn, across the
  shards' boundaries;
* ``layers.moe_apply`` of deepseek-v2-lite-16b reduced, forward and
  backward, its groups split over ``data`` and its experts over
  ``model`` (``spmd.group_local``, ``spmd.local_experts``);
* prefill and decode of gemma2-9b reduced (local layers' ring caches,
  softcaps, the vocabulary split: ``spmd.embedding``) and of
  deepseek-v2-lite-16b reduced (MLA's prefill with its value pad shard by
  shard and its decode on a position-split latent cache, the MoE layer),
  as the dry run places their inputs.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch_parity  # noqa: F401  (one torch thread a test worker)
import torch_spmd_ranks as R

from repro_torch.distributed.launch import spawn

TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = [(2, 2), (4, 2)]  # (ranks, model axis)


def _close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    else:
        assert np.shape(got) == np.shape(want), what
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)


def _held(fn, ranks, model_axis, *args):
    want = fn(*args, None)
    for r, got in enumerate(spawn(fn, ranks, *args, model_axis,
                                  timeout_s=300)):
        _close(got, want, f"rank {r}")


@pytest.mark.parametrize("ranks,model_axis", RANKS)
def test_split_k_decode_and_index_copy_match_one_rank(ranks, model_axis):
    _held(R.decode_attention_run, ranks, model_axis)


@pytest.mark.parametrize("ranks,model_axis", RANKS)
def test_moe_apply_matches_one_rank(ranks, model_axis):
    _held(R.moe_run, ranks, model_axis)


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("ranks,model_axis", RANKS)
def test_prefill_and_decode_match_one_rank(arch, ranks, model_axis):
    _held(R.serve_run, ranks, model_axis, arch)
