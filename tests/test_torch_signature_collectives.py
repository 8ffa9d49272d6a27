"""The profile's collectives under the reference's kind names
(``repro_torch.core.signature.COLLECTIVE_KINDS``): each functional
collective op maps to the HLO kind the reference parses
(``repro/core/signature.py``), with its operand's bytes; waits and
autograd wrappers are control with no bytes; an unmapped op raises.
The gloo run that holds a real profile to it is in
``test_torch_cluster_mesh.py``."""
from __future__ import annotations

import pytest
import torch
import torch.distributed._functional_collectives  # noqa: F401  (its ops)

from repro.core import accuracy as jaccuracy
from repro.core.decompose import COLLECTIVE_TO_MOTIF as J_COLLECTIVE_TO_MOTIF
from repro_torch.core import signature as tsig
from repro_torch.core.accuracy import COLLECTIVE_KIND_FRACS, normalized_vector
from repro_torch.core.signature import ProfileStats, Signature

FUNCTIONAL = torch.ops._c10d_functional

# every op of the functional-collective namespaces torch defines
CASES = [
    ("all_reduce", "all-reduce"),
    ("all_reduce_", "all-reduce"),
    ("all_reduce_coalesced", "all-reduce"),
    ("all_gather_into_tensor", "all-gather"),
    ("all_gather_into_tensor_out", "all-gather"),
    ("all_gather_into_tensor_coalesced", "all-gather"),
    ("reduce_scatter_tensor", "reduce-scatter"),
    ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
    ("all_to_all_single", "all-to-all"),
    ("broadcast", "collective-broadcast"),
    ("broadcast_", "collective-broadcast"),
]


@pytest.mark.parametrize("name,kind", CASES)
def test_each_functional_collective_has_the_reference_kind(name, kind):
    op = getattr(FUNCTIONAL, name).default
    assert tsig.classify_op(op) == "collective"
    assert tsig.collective_kind(op) == kind


def test_the_kinds_are_the_reference_metrics_kinds():
    # every kind the mapping produces is an HLO kind the reference knows
    # (its decomposition's table), the kinds the metrics read are all
    # produced but collective-permute (no functional collective permutes),
    # and the port's fraction table is the reference's
    kinds = set(tsig.COLLECTIVE_KINDS.values())
    assert kinds <= set(J_COLLECTIVE_TO_MOTIF)
    assert {k for k, _ in COLLECTIVE_KIND_FRACS} - kinds == {
        "collective-permute"}
    assert COLLECTIVE_KIND_FRACS == jaccuracy.COLLECTIVE_KIND_FRACS


@pytest.mark.parametrize("name", ["wait_tensor", "_wrap_tensor_autograd"])
def test_bookkeeping_ops_are_control_with_zero_bytes(name):
    op = getattr(FUNCTIONAL, name).default
    assert tsig.classify_op(op) == "control"
    st = ProfileStats()
    x = torch.ones(1024)
    st.record(op, (x,), {}, x)
    assert st.collective_bytes == {} and st.bytes == 0.0
    assert st.op_counts == {"control": 1}


def test_a_collective_counts_its_operand_bytes():
    st = ProfileStats()
    x = torch.ones(256)  # 1 KiB operand, 2 KiB gathered
    st.record(FUNCTIONAL.all_gather_into_tensor.default, (x, 2, "0"), {},
              torch.ones(512))
    st.record(FUNCTIONAL.all_reduce.default, (x, "sum", "0"), {}, x)
    assert st.collective_bytes == {"all-gather": 1024.0,
                                   "all-reduce": 1024.0}


def test_an_unmapped_collective_raises():
    class FakeOp:  # an op of the namespace the table does not know
        namespace = "_c10d_functional"
        _overloadname = "default"

        class overloadpacket:
            __name__ = "all_reduce_but_new"

    with pytest.raises(ValueError, match="unmapped collective"):
        tsig.classify_op(FakeOp())


def test_kinds_reach_the_metric_vector():
    sig = Signature(flops=1.0, bytes=4096.0,
                    collective_bytes={"all-reduce": 1024.0,
                                      "all-gather": 512.0})
    v = sig.vector()
    assert v["coll_all_reduce"] == 1024.0 and v["coll_all_gather"] == 512.0
    m = normalized_vector(sig, include_rates=False)
    assert m["coll_frac"] == 1536.0 / 4096.0
    assert m["coll_all_reduce_frac"] == 0.25
