"""The MoE layer's expert weight gradients when its token groups do not
divide the data axis, on real values over gloo ranks on the CPU.

Such groups run whole on every rank of the data axis, so every rank
would compute the same expert weight gradients; ``spmd.local_experts``
has each compute only the part of them that the optimizer state keeps on
it (the ZeRO-1 rule), as the reference's partitioner does.  The layer's
output, its input's gradient and every weight's gradient, made whole,
are held against one rank at ``rtol=atol=1e-4`` in f32 (the tolerance
of ``tests/test_torch_spmd_values.py``): 2 groups over a data axis of 4
(mesh (4, 1)) and 1 group over 2 with the experts over ``model`` (mesh
(2, 2)).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch_parity  # noqa: F401  (one torch thread a test worker)
import torch_spmd_ranks as R

from repro_torch.distributed.launch import spawn

TOL = dict(rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("ranks,model_axis,batch", [(4, 1, 2), (4, 2, 1)])
def test_whole_groups_match_one_rank(ranks, model_axis, batch):
    want = R.moe_run(None, batch)
    for r, got in enumerate(spawn(R.moe_run, ranks, model_axis, batch,
                                  timeout_s=300)):
        _close(got, want, f"rank {r}")
