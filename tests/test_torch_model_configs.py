"""The port's config registry (``repro_torch.configs``) against the JAX
package's: every field of every assigned architecture, the parameter
counts, ``reduced()``, the shape cells and the lookups."""
from __future__ import annotations

import dataclasses

import pytest

import repro.configs as R
import repro_torch.configs as P


def _typed(cfg) -> dict:
    """Every field of a config (sub-configs as dicts, tuples kept as
    tuples) with each value's type, so 1 and 1.0 differ."""
    def typed(v):
        if isinstance(v, dict):
            return {k: typed(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(typed(x) for x in v)
        return (type(v).__name__, v)
    return typed(dataclasses.asdict(cfg))


def test_the_registry_lists_the_same_architectures():
    assert P.ARCH_NAMES == R.ARCH_NAMES
    assert len(P.ARCH_NAMES) == 10
    assert sorted(P.__all__) == sorted(R.__all__)


@pytest.mark.parametrize("name", R.ARCH_NAMES)
def test_every_field_equals_the_reference(name):
    got, want = P.get_config(name), R.get_config(name)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert _typed(got) == _typed(want)


@pytest.mark.parametrize("name", R.ARCH_NAMES)
def test_param_counts_equal_the_reference(name):
    got = dict(P.get_config(name).param_counts())
    assert got == dict(R.get_config(name).param_counts())
    assert got["total"] >= got["active"] > 0


@pytest.mark.parametrize("kw", [{}, {"layers": 4, "vocab": 256}],
                         ids=["default", "layers4_vocab256"])
@pytest.mark.parametrize("name", R.ARCH_NAMES)
def test_reduced_equals_the_reference(name, kw):
    got = P.reduced(P.get_config(name), **kw)
    want = R.reduced(R.get_config(name), **kw)
    assert _typed(got) == _typed(want)
    assert dict(got.param_counts()) == dict(want.param_counts())


@pytest.mark.parametrize("name", R.ARCH_NAMES)
def test_derived_fields_equal_the_reference(name):
    got, want = P.get_config(name), R.get_config(name)
    assert got.resolved_head_dim() == want.resolved_head_dim()
    for n in (1, 7, got.num_layers):
        assert got.pattern_for(n) == want.pattern_for(n)
    for cell in R.ALL_SHAPES:
        assert got.skipped(cell.name) == want.skipped(cell.name)
    assert _typed(got.replace(num_layers=3)) == _typed(
        want.replace(num_layers=3))


def test_shape_cells_equal_the_reference():
    assert [dataclasses.asdict(c) for c in P.ALL_SHAPES] == [
        dataclasses.asdict(c) for c in R.ALL_SHAPES]
    assert list(P.SHAPES_BY_NAME) == list(R.SHAPES_BY_NAME)
    for sub in ("MoEConfig", "MLAConfig", "SSMConfig", "RGLRUConfig"):
        assert dataclasses.asdict(getattr(P, sub)()) == dataclasses.asdict(
            getattr(R, sub)())


def test_an_unknown_name_raises_as_the_reference_does():
    with pytest.raises(KeyError) as got:
        P.get_config("gpt-5")
    with pytest.raises(KeyError) as want:
        R.get_config("gpt-5")
    assert str(got.value) == str(want.value)
