"""The port's training driver (``repro_torch.launch``) against the JAX
package's ``repro.launch``: ``reduce_config`` field for field for all ten
archs; ``train`` on a tiny config on the CPU (the loss falls; a fault
injected through ``fault_hook`` at a step right after a checkpoint
recovers to the same losses as a run without it); ``make_host_mesh``;
and the two command lines
(``python -m repro_torch.launch.train`` and ``repro_torch.bench.train_lm``)
at a tiny size."""
from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.distributed as dist
import torch_parity  # noqa: F401  (one torch thread a test worker)

from repro.configs import ARCH_NAMES, get_config as ref_get
from repro.launch.train import reduce_config as ref_reduce
from repro_torch.bench import train_lm
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod, train as train_mod

#: a tiny tinyllama-1.1b (2 layers, d_model 128, vocab 2048): its untied
#: head starts the loss ~0.6 above ln(vocab), so it falls within steps
TINY = dict(steps=16, batch=4, seq=64, reduce=16, lr=3e-3, device="cpu",
            log_every=0)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("factor", [1, 6, 16])
def test_reduce_config_is_the_reference_s(name, factor):
    want = dataclasses.asdict(ref_reduce(ref_get(name), factor))
    got = dataclasses.asdict(train_mod.reduce_config(get_config(name),
                                                     factor))
    assert got == want


def test_train_makes_the_loss_fall(tmp_path):
    out = train_mod.train("tinyllama-1.1b", ckpt_dir=str(tmp_path),
                          ckpt_every=8, **TINY)
    assert out["final_step"] == 16 and out["recoveries"] == 0
    assert out["last_loss"] < out["first_loss"] - 0.05, out
    assert out["params"] == 819_840
    # step 0's anchor, the step-7 and step-15 saves, and the final one
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                  if p.name.startswith("step_")) == [0, 7, 15]


def test_an_injected_fault_recovers_to_the_same_losses(tmp_path):
    clean = train_mod.train("tinyllama-1.1b", ckpt_dir=str(tmp_path / "a"),
                            ckpt_every=4, **dict(TINY, steps=10))
    faults = []

    def hook(step):
        if step == 8 and not faults:  # step 7's checkpoint is the last good
            faults.append(step)
            raise RuntimeError("injected")

    hurt = train_mod.train("tinyllama-1.1b", ckpt_dir=str(tmp_path / "b"),
                           ckpt_every=4, fault_hook=hook,
                           **dict(TINY, steps=10))
    assert faults == [8] and hurt["recoveries"] == 1
    assert clean["recoveries"] == 0
    log_a, log_b = clean["metrics_log"], hurt["metrics_log"]
    assert [m["step"] for m in log_a] == [m["step"] for m in log_b]
    assert [m["retries"] for m in log_b] == [0, 0, 0, 1, 0]
    for a, b in zip(log_a, log_b):
        assert a["loss"] == b["loss"], (a, b)


def test_make_host_mesh_and_a_placed_pipeline(tmp_path):
    assert mesh_mod.make_host_mesh(1, device="cpu") is None
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        m = mesh_mod.make_host_mesh(1, device="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.mesh.shape) == (1, 1) and m.device_type == "cpu"
        with pytest.raises(ValueError):
            mesh_mod.make_host_mesh(2, device="cpu")
        # under the mesh, the pipeline places each batch by its shardings
        from torch.distributed.tensor import DTensor

        from repro_torch.data import DataPipeline, synthetic_lm_batch
        from repro_torch.distributed import named_sharding, use_mesh

        with use_mesh(m):
            sh = named_sharding((4, 8), ("batch", None), m)
            pipe = DataPipeline(
                lambda sd, st: synthetic_lm_batch(sd, st, 4, 8, 100),
                shardings={"tokens": sh, "labels": sh}, device="cpu")
            try:
                step, batch = next(pipe)
            finally:
                pipe.close()
        want = synthetic_lm_batch(0, 0, 4, 8, 100)
        for k in want:
            assert isinstance(batch[k], DTensor)
            assert batch[k].placements == sh
            assert (batch[k].full_tensor().numpy() == want[k]).all()
    finally:
        dist.destroy_process_group()


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        train_mod.train("tinyllama-1.1b", steps=1)


def test_the_command_lines_run(tmp_path, capsys):
    assert train_mod.main(["--arch", "tinyllama-1.1b", "--steps", "3",
                           "--batch", "2", "--seq", "16", "--reduce", "16",
                           "--ckpt-dir", str(tmp_path / "a"),
                           "--device", "cpu"]) == 0
    assert "[train] tinyllama-1.1b" in capsys.readouterr().out
    out = train_lm.run(["--steps", "3", "--reduce", "24", "--device",
                        "cpu"])
    assert out["final_step"] == 3 and out["recoveries"] == 0
    assert "[train_lm] qwen3-4b/reduce24" in capsys.readouterr().out
