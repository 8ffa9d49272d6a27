"""What crosses between the JAX package and the port: proxies, arrays and
signatures.  The system has no weights; both packages compute on the
same proxy JSON and the same numpy arrays.  Nothing here imports the JAX
package: proxies arrive as JSON text, arrays as numpy, signatures as
plain field dictionaries.
"""
from __future__ import annotations

import json
from typing import Any, Mapping

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
    a = np.ascontiguousarray(a)
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
