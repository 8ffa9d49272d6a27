"""The port's ``runtime/fault_tolerance.py`` against the reference's:
its tests (``test_fault_tolerance.py`` and the runner tests of
``test_substrates.py``) on the port, then the same scripted runs — one
``train_step``, fault hook and ``RunnerConfig`` — through both runners,
which must end alike: final state, recoveries, final step, each step's
retries and loss, and the checkpoint steps kept.  ``StepMonitor`` is held
to the reference's on the same walls."""
from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime import FaultTolerantRunner as JFaultTolerantRunner
from repro.runtime import RunnerConfig as JRunnerConfig
from repro.runtime import StepMonitor as JStepMonitor
from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig, StepMonitor


# -- StepMonitor: injected delays (observe takes dt) -----------------------


def test_first_observation_seeds_ema_not_straggler():
    mon = StepMonitor()
    out = mon.observe(0, 10.0)
    assert out["straggler"] is False
    assert mon.ema_s == 10.0
    assert mon.stragglers == []


def test_straggler_flagged_beyond_factor():
    mon = StepMonitor(straggler_factor=2.5)
    for step in range(5):
        assert mon.observe(step, 1.0)["straggler"] is False
    out = mon.observe(5, 2.6)
    assert out["straggler"] is True
    assert mon.stragglers == [5]
    assert mon.observe(6, 2.4)["straggler"] is False


def test_stragglers_do_not_contaminate_ema():
    mon = StepMonitor(straggler_factor=2.5, ema_alpha=0.5)
    mon.observe(0, 1.0)
    mon.observe(1, 100.0)
    assert mon.ema_s == 1.0
    for step in range(2, 6):
        assert mon.observe(step, 50.0)["straggler"] is True
    assert mon.ema_s == 1.0
    assert mon.stragglers == [1, 2, 3, 4, 5]


def test_normal_steps_move_ema():
    mon = StepMonitor(ema_alpha=0.5)
    mon.observe(0, 1.0)
    mon.observe(1, 2.0)
    assert mon.ema_s == pytest.approx(1.5)


def test_stall_detection():
    mon = StepMonitor(stall_timeout_s=0.0)
    mon.last_progress -= 1.0
    assert mon.stalled() is True
    mon.observe(0, 0.1)
    mon.stall_timeout_s = 300.0
    assert mon.stalled() is False


def test_straggler_detection():
    mon = StepMonitor(ema_alpha=0.5, straggler_factor=2.0)
    for _ in range(5):
        mon.observe(0, 1.0)
    stats = mon.observe(6, 10.0)
    assert stats["straggler"]
    assert 6 in mon.stragglers
    assert mon.ema_s < 1.5


@pytest.mark.parametrize("alpha,factor", [(0.1, 2.5), (0.5, 2.0), (0.9, 1.2)])
def test_monitor_matches_the_reference_on_the_same_walls(alpha, factor):
    walls = np.random.default_rng(3).lognormal(0.0, 0.8, 64).tolist()
    ref, port = (JStepMonitor(ema_alpha=alpha, straggler_factor=factor),
                 StepMonitor(ema_alpha=alpha, straggler_factor=factor))
    for step, dt in enumerate(walls):
        want, got = ref.observe(step, dt), port.observe(step, dt)
        assert got == want
    assert port.stragglers == ref.stragglers and port.stragglers


# -- FaultTolerantRunner on the port ---------------------------------------


def _make_runner(tmp_path, train_step, total_steps=6, fault_hook=None,
                 max_retries=2):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    cfg = RunnerConfig(total_steps=total_steps, checkpoint_every=2,
                       max_retries_per_step=max_retries, async_save=False)
    state = {"w": torch.zeros(2), "step_count": torch.zeros(())}
    return FaultTolerantRunner(train_step, state, ckpt, cfg,
                               monitor=StepMonitor(), fault_hook=fault_hook)


def _good_step(state, batch):
    new = {"w": state["w"] + batch, "step_count": state["step_count"] + 1}
    return new, {"loss": torch.sum(new["w"])}


def test_clean_run_reaches_final_step(tmp_path):
    runner = _make_runner(tmp_path, _good_step)
    out = runner.run(lambda step: torch.ones(2))
    assert out["final_step"] == 6
    assert out["recoveries"] == 0
    assert float(runner.state["step_count"]) == 6.0
    assert [m["step"] for m in runner.metrics_log] == list(range(6))


def test_nan_loss_triggers_restore_and_retry(tmp_path):
    poisoned = {"count": 0}

    def step_fn(state, batch):
        new, metrics = _good_step(state, batch)
        if float(state["step_count"]) == 3.0 and poisoned["count"] == 0:
            poisoned["count"] += 1
            return new, {"loss": torch.tensor(float("nan"))}
        return new, metrics

    runner = _make_runner(tmp_path, step_fn)
    out = runner.run(lambda step: torch.ones(2))
    assert poisoned["count"] == 1
    assert out["recoveries"] >= 1
    assert out["final_step"] == 6
    assert float(runner.state["step_count"]) == 5.0
    assert not any(m != m for m in
                   (r.get("loss") for r in runner.metrics_log))


def test_fault_hook_exception_recovers(tmp_path):
    crashes = {"n": 0}

    def hook(step):
        if step == 2 and crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("injected fault at step 2")

    runner = _make_runner(tmp_path, _good_step, fault_hook=hook)
    out = runner.run(lambda step: torch.ones(2))
    assert crashes["n"] == 1
    assert out["recoveries"] == 1
    assert float(runner.state["step_count"]) == 6.0


def test_retried_step_wall_excludes_failed_attempt(tmp_path):
    """The per-step wall restarts on every retry ATTEMPT: a slow failed
    attempt stays out of the retried step's wall and the EMA."""
    crashes = {"n": 0}

    def hook(step):
        if step == 3 and crashes["n"] == 0:
            crashes["n"] += 1
            time.sleep(0.3)
            raise RuntimeError("injected slow fault")

    runner = _make_runner(tmp_path, _good_step, fault_hook=hook)
    out = runner.run(lambda step: torch.ones(2))
    assert crashes["n"] == 1 and out["recoveries"] == 1
    rec = next(m for m in runner.metrics_log if m["step"] == 3)
    assert rec["step_time_s"] < 0.25, rec
    assert rec["retries"] == 1
    assert runner.monitor.ema_s < 0.25
    assert all(m["retries"] == 0 for m in runner.metrics_log
               if m["step"] != 3)


def test_persistent_fault_exhausts_retries(tmp_path):
    def hook(step):
        if step == 1:
            raise RuntimeError("hard fault")

    runner = _make_runner(tmp_path, _good_step, fault_hook=hook,
                          max_retries=2)
    with pytest.raises(RuntimeError, match="hard fault"):
        runner.run(lambda step: torch.ones(2))
    assert runner.recoveries == 2


def test_resume_from_latest_checkpoint(tmp_path):
    runner = _make_runner(tmp_path, _good_step, total_steps=4)
    runner.run(lambda step: torch.ones(2))
    resumed = _make_runner(tmp_path, _good_step, total_steps=8)
    assert resumed.start_step == 4
    out = resumed.run(lambda step: torch.ones(2))
    assert out["final_step"] == 8
    assert float(resumed.state["step_count"]) == 8.0


def test_runner_recovers_from_injected_fault(tmp_path):
    def train_step(st, batch):
        w = st["w"] + 1.0
        return {"w": w}, {"loss": w.mean()}

    faults = {3: 1}

    def hook(step):
        if faults.get(step, 0) > 0:
            faults[step] -= 1
            raise RuntimeError("injected")

    cm = CheckpointManager(str(tmp_path), keep=3)
    r = FaultTolerantRunner(train_step, {"w": torch.zeros(2)}, cm,
                            RunnerConfig(total_steps=6, checkpoint_every=2,
                                         async_save=False),
                            fault_hook=hook)
    out = r.run(lambda s: {})
    assert out["final_step"] == 6
    assert out["recoveries"] == 1


def test_runner_nan_guard(tmp_path):
    calls = {"n": 0}

    def train_step(st, batch):
        calls["n"] += 1
        bad = calls["n"] == 2
        w = st["w"] + 1.0
        loss = torch.where(torch.tensor(bad), torch.tensor(float("nan")),
                           w.mean())
        return {"w": w}, {"loss": loss}

    cm = CheckpointManager(str(tmp_path), keep=3)
    r = FaultTolerantRunner(train_step, {"w": torch.zeros(2)}, cm,
                            RunnerConfig(total_steps=3, checkpoint_every=1,
                                         async_save=False))
    out = r.run(lambda s: {})
    assert out["final_step"] == 3
    assert r.recoveries >= 1


def test_runner_resumes_from_checkpoint(tmp_path):
    def train_step(st, batch):
        return {"w": st["w"] + 1.0}, {"loss": st["w"].mean()}

    cm = CheckpointManager(str(tmp_path), keep=5)
    r1 = FaultTolerantRunner(train_step, {"w": torch.zeros(2)}, cm,
                             RunnerConfig(total_steps=4, checkpoint_every=2,
                                          async_save=False))
    r1.run(lambda s: {})
    r2 = FaultTolerantRunner(train_step, {"w": torch.zeros(2)}, cm,
                             RunnerConfig(total_steps=6, checkpoint_every=2,
                                          async_save=False))
    assert r2.start_step > 0
    out = r2.run(lambda s: {})
    assert out["final_step"] == 6


# -- the same scripted runs through both runners ---------------------------

#: one framework's pieces: zeros, ones, checkpoint manager, runner,
#: config, monitor
PACKAGES = {
    "jax": (jnp.zeros, jnp.ones, JCheckpointManager, JFaultTolerantRunner,
            JRunnerConfig, JStepMonitor),
    "port": (torch.zeros, torch.ones, CheckpointManager,
             FaultTolerantRunner, RunnerConfig, StepMonitor),
}


def train_step(state, batch):
    """One step both frameworks run: ``+``, ``*`` and ``.sum()`` are
    common to their arrays; the loss is poisoned once where the script's
    ``nan_at`` says (read through ``float`` of the step count)."""
    new = {"w": state["w"] + batch * 0.5, "n": state["n"] + 1}
    loss = (new["w"] * new["w"]).sum()
    if float(state["n"]) in train_step.nan_at:
        train_step.nan_at.discard(float(state["n"]))
        loss = loss * float("nan")
    return new, {"loss": loss, "lr": 0.1}


#: script -> (config kwargs, faults {step: times}, NaN losses at these
#: step counts, total steps of a resumed second runner or None)
SCRIPTS = {
    "clean": (dict(), {}, (), None),
    "fault_once": (dict(), {3: 1}, (), None),
    "fault_twice_one_step": (dict(), {2: 2}, (), None),
    "nan_once": (dict(), {}, (3.0,), None),
    "fault_and_nan": (dict(checkpoint_every=3), {4: 1}, (1.0,), None),
    "exhausts": (dict(), {1: 9}, (), None),
    "async_saves": (dict(async_save=True, checkpoint_every=1), {5: 1}, (),
                    None),
    "resume": (dict(), {}, (), 9),
}


def _script_run(pkg, script, directory):
    zeros, ones, Ckpt, Runner, Cfg, Mon = PACKAGES[pkg]
    kw, faults, nans, resume_to = SCRIPTS[script]
    faults = dict(faults)
    train_step.nan_at = set(nans)

    def hook(step):
        if faults.get(step, 0) > 0:
            faults[step] -= 1
            raise RuntimeError(f"injected at {step}")

    cfg = Cfg(**{"total_steps": 6, "checkpoint_every": 2,
                 "max_retries_per_step": 2, "async_save": False, **kw})
    ckpt = Ckpt(str(directory), keep=3)

    def make(total):
        return Runner(train_step, {"w": zeros((3,)), "n": zeros(())}, ckpt,
                      Cfg(**{**vars(cfg), "total_steps": total}),
                      monitor=Mon(), fault_hook=hook)

    runner = make(cfg.total_steps)
    try:
        out = runner.run(lambda step: ones((3,)) * (step + 1))
        error = None
    except RuntimeError as e:
        out, error = None, str(e)
    if resume_to is not None:
        runner = make(resume_to)
        out = runner.run(lambda step: ones((3,)) * (step + 1))
    ckpt.wait()
    return {"out": out, "error": error, "recoveries": runner.recoveries,
            "start_step": runner.start_step,
            "state": {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                      for k, v in runner.state.items()},
            "log": [(m["step"], m["retries"], m["loss"], m["lr"],
                     m["straggler"] in (True, False))
                    for m in runner.metrics_log],
            "kept": ckpt.all_steps()}


def _untimed(out):
    """A run's result without its stragglers (wall-clock dependent)."""
    return out and {k: v for k, v in out.items() if k != "stragglers"}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_both_runners_end_alike(tmp_path, script):
    want = _script_run("jax", script, tmp_path / "jax")
    got = _script_run("port", script, tmp_path / "port")
    assert _untimed(got["out"]) == _untimed(want["out"])
    assert got["error"] == want["error"]
    assert got["recoveries"] == want["recoveries"]
    assert got["start_step"] == want["start_step"]
    for k in ("w", "n"):
        np.testing.assert_array_equal(got["state"][k], want["state"][k])
    assert got["kept"] == want["kept"]
    assert [r[:2] for r in got["log"]] == [r[:2] for r in want["log"]]
    np.testing.assert_allclose([r[2] for r in got["log"]],
                               [r[2] for r in want["log"]], rtol=1e-6)
    assert [r[3:] for r in got["log"]] == [r[3:] for r in want["log"]]
