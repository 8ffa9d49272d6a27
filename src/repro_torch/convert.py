"""What crosses between the JAX package and the port: proxies, arrays,
signatures and workload params.  The proxy system itself has no weights;
both packages compute on the same proxy JSON and the same numpy arrays.
The AI workloads' params differ only in layout: the reference keeps conv
kernels HWIO, the port OIHW (dense matrices are ``(din, dout)`` in both).
The model zoo's params and caches, and a train state (params, AdamW
moments and step, compression residuals), keep the reference's keys,
shapes and dtypes.
Nothing here imports the JAX package: proxies arrive as JSON text,
arrays and params as numpy, signatures as plain field dictionaries.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.proxy_graph import ProxyBenchmark
from repro_torch.core.signature import Signature
from repro_torch.device import DeviceLike, resolve_device

#: reference substrate -> port substrate
SUBSTRATE_MAP = {"xla": "torch", "pallas": "hopper"}


def proxy_from_reference_json(text: str) -> ProxyBenchmark:
    """A reference ``ProxyBenchmark.to_json()`` as a port proxy, with the
    substrate mapped ``xla -> torch`` and ``pallas -> hopper``."""
    d = json.loads(text)
    for nd in d["nodes"]:
        sub = nd["p"].get("substrate", "xla")
        if sub not in SUBSTRATE_MAP:
            raise ValueError(f"{nd['id']}: unknown reference substrate "
                             f"{sub!r}")
        nd["p"]["substrate"] = SUBSTRATE_MAP[sub]
    return ProxyBenchmark.from_json(json.dumps(d))


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(a.shape)  # a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensors_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A pytree of numpy arrays (dicts, lists, tuples) as tensors on
    ``device``, dtypes kept (uint32 and bfloat16 included)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tensors_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensors_from_numpy(v, dev) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return _tensor(np.asarray(tree), dev)
    return tree


def params_from_reference(params: Mapping[str, Any],
                          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A reference workload's params (numpy, conv kernels HWIO) as the
    port's, on ``device``: conv kernels OIHW, every other array as it is."""
    tensors = tensors_from_numpy(dict(params), device)
    return {k: v.permute(3, 2, 0, 1).contiguous() if v.ndim == 4 else v
            for k, v in tensors.items()}


def params_to_reference(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_reference`: numpy, conv kernels
    HWIO."""
    return {k: (v.permute(2, 3, 1, 0) if v.ndim == 4 else v).detach().cpu()
            .contiguous().numpy() for k, v in params.items()}


def model_params_from_reference(tree: Mapping[str, Any],
                                device: DeviceLike = None) -> Dict[str, Any]:
    """A reference zoo model's params, or a cache tree, as a nested dict of
    numpy arrays (``jax.tree.map(np.asarray, tree)``) -> the port's tree on
    ``device``: the same keys, shapes and dtypes, bfloat16 included."""
    return tensors_from_numpy(dict(tree), device)


def train_state_from_reference(tree: Mapping[str, Any],
                               device: DeviceLike = None) -> Dict[str, Any]:
    """A reference ``TrainState`` as numpy (``jax.tree.map(np.asarray,
    state)``: ``params``, ``opt`` with ``m``, ``v`` and the 0-d int32
    ``step``, and ``comp`` when it compresses) -> the port's state on
    ``device``, every leaf's dtype kept, so both packages can take the
    same step from the same state."""
    extra = set(tree) - {"params", "opt", "comp"}
    if extra or set(tree.get("opt", {})) != {"m", "v", "step"}:
        raise ValueError(f"not a reference TrainState: keys {sorted(tree)}, "
                         f"opt {sorted(tree.get('opt', {}))}")
    step = np.asarray(tree["opt"]["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt.step must be a 0-d int32, not {step.dtype} "
                         f"{step.shape}")
    return tensors_from_numpy(dict(tree), device)


_SIGNATURE_FIELDS = ("flops", "bytes", "transcendentals", "peak_memory",
                     "op_mix", "collective_bytes", "dot_flops", "conv_flops",
                     "wall_time", "raw_cost")


def signature_from_reference(fields: Mapping[str, Any]) -> Signature:
    """A reference ``Signature``'s fields (``dataclasses.asdict``) as a
    port ``Signature``."""
    kw = {k: fields[k] for k in _SIGNATURE_FIELDS if k in fields}
    for k in ("op_mix", "collective_bytes", "raw_cost"):
        if k in kw:
            kw[k] = {str(a): float(b) for a, b in dict(kw[k]).items()}
    for k in ("flops", "bytes", "transcendentals", "peak_memory",
              "dot_flops", "conv_flops"):
        if k in kw:
            kw[k] = float(kw[k])
    return Signature(**kw)
