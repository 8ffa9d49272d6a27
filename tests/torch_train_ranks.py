"""What each rank of the gloo groups in ``test_torch_launch_train_dp.py``
runs (a module of its own: a spawned rank imports it, and it imports
only ``repro_torch``, never JAX)."""
from __future__ import annotations

from typing import Any, Dict, Optional


class FailOnce:
    """A fault hook raising once, at the first attempt of ``step``."""

    def __init__(self, step: int):
        self.step, self.fired = step, False

    def __call__(self, step: int) -> None:
        if step == self.step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected fault at step {step}")


def train_rank(arch: str, kw: Dict[str, Any],
               fault_step: Optional[int] = None) -> Dict[str, Any]:
    """``launch.train.rank_train`` with a fault at ``fault_step``: the
    rank's result, rank 0's with the final params gathered whole."""
    from repro_torch.launch.train import rank_train

    hook = FailOnce(fault_step) if fault_step is not None else None
    return rank_train(arch, dict(kw, fault_hook=hook), params=True)
