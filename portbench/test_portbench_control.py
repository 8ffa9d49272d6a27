"""The control and the faults, on tiny copies of the cells on the CPU.

The control is the reference computed in TF32, the step below the
configurations' float32, put in the program's place: it has to fail
every cell's limits.  Each fault breaks the timed path underneath a
whole run of the harness, which has to come out not correct.  (The
chip-sized readings the limits were set from are ``calibrate.py``'s.)"""
import json
from pathlib import Path

import pytest
import torch

from portbench import check, harness, reference, tiny
from repro_torch.core.motifs.base import MOTIFS

CPU = torch.device("cpu")
BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json")
                   .read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_every_cell(name, tmp_path):
    cell = harness.load_cell(name, tiny.tiny_root(tmp_path, [name]))
    for seed in (1, 2, 2 ** 31 + 3):
        ref, choices = reference.run(cell.config["proxy"], seed, CPU)
        ctrl, _ = reference.run(cell.config["proxy"], seed, CPU, "tf32")
        numbers = check.compare(ctrl, ref, choices)
        assert not check.judge(numbers, cell.limits), numbers


def altered(leaf, flip):
    """One element of one output changed where it is produced."""
    def fault(orig, p, inputs, variant):
        out = dict(orig(p, inputs, variant))
        x = out[leaf].clone()
        flat = (x.view(torch.int32) if x.dtype == torch.uint32
                else x).reshape(-1)  # uint32 through its bits
        flat[0] = flip(flat[0])
        out[leaf] = x
        return out
    return fault


def average_over_half(orig, p, inputs, variant):
    """Half of the rows left out, the mean taken over the rest."""
    x = inputs["x"]
    return orig(p, dict(inputs, x=x[: x.shape[0] // 2]), variant)


def unchanged(*leaves):
    """The step returns its inputs as it was given them."""
    def fault(orig, p, inputs, variant):
        return {k: inputs[k] for k in leaves}
    return fault


def unsorted(orig, p, inputs, variant):
    return {"keys": inputs["keys"], "payload": inputs["payload"]}


FAULTS = {
    "kmeans.proxy": [
        ("matrix", altered("dist", lambda v: v * 1.001)),
        ("sort", altered("keys", lambda v: v + 1)),
        ("statistics", average_over_half),
        ("sort", unsorted),
        ("matrix", unchanged("x"))],
}


def test_every_cell_has_its_faults():
    assert {c.split("_torch")[0] for c in CELLS} == set(FAULTS)


@pytest.mark.parametrize("name,motif,fault", [
    (cell, m, f) for base in FAULTS for cell in (base, base + "_torch")
    for m, f in FAULTS[base]])
def test_a_broken_timed_path_is_not_correct(name, motif, fault, tmp_path,
                                            monkeypatch):
    cell = harness.load_cell(name, tiny.tiny_root(tmp_path, [name]))
    inst = MOTIFS[motif]
    orig = inst.execute
    monkeypatch.setattr(inst, "execute", lambda p, inputs, variant="":
                        fault(orig, p, inputs, variant))
    r = harness.run_cell(cell, 77, 0.05, False, CPU, 0.0)
    assert r["correct"] is False and r["failed"] == r["attempted"]
