"""The plain reference of a frozen proxy: its nodes run in order, each
motif's inputs made again from the seed, then forwarded and perturbed
from its upstream outputs, then applied as many times as its weight
says.

A motif's reference is the module of this package named after it
(``matrix``, ``statistics``, ...): ``VARIANTS``, ``DEFAULT``,
``inputs(p, seed, device)``, ``apply(p, inputs, variant, precision)``
returning ``(outputs, choices)``, ``flops(p, variant)``, and, where the motif
multiplies matrices, ``products(p, variant)``: the products one
invocation makes.  ``choices``
maps an output that picks an index (an argmin, an argmax) to the scores
it picked from and whether the least or the greatest wins.  A
configuration that needs another motif brings its module.

Nothing here imports the program under test.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

from portbench.reference.gen import derive_seed, params, repeats

Outputs = Dict[str, Dict[str, torch.Tensor]]
Choices = Dict[str, Dict[str, Tuple[torch.Tensor, str]]]


def motif(name: str) -> ModuleType:
    """The reference module of motif ``name``."""
    if not name.isidentifier():
        raise KeyError(f"no reference for motif {name!r}")
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as exc:
        raise KeyError(f"no reference for motif {name!r}") from exc


def variant_of(mod: ModuleType, variant: str) -> str:
    v = variant or mod.DEFAULT
    if v not in mod.VARIANTS:
        raise KeyError(f"{mod.__name__}: unknown variant {v!r}")
    return v


def checksum(outputs: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """1e-12 times the sum of each leaf's first 8 elements, in float32."""
    leaves = list(outputs.values())
    acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        probe = leaf.reshape(-1)[:8]
        if probe.dtype == torch.uint32:
            probe = probe.to(torch.int64)
        acc = acc + torch.sum(probe.to(torch.float32)) * 1e-12
    return acc


def perturb(tree: Mapping[str, Any], eps: torch.Tensor) -> Dict[str, Any]:
    """``eps`` added to every float leaf; every integer leaf but int32
    XORed with ``eps != 0`` (uint32 through its bits)."""
    def one(x):
        if x.dtype.is_floating_point:
            return x + eps.to(x.dtype)
        if x.dtype in (torch.int32, torch.bool):
            return x
        flip = (eps != 0.0).to(torch.int64)
        if x.dtype == torch.uint32:
            b = x.view(torch.int32).to(torch.int64) ^ flip
            return b.to(torch.int32).view(torch.uint32)
        return x ^ flip.to(x.dtype)
    return {k: one(v) for k, v in tree.items()}


def forward(inputs: Mapping[str, Any],
            upstream: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """Each input leaf replaced by the first upstream output of the same
    name, shape and dtype."""
    avail: Dict[str, torch.Tensor] = {}
    for out in upstream:
        for k, v in out.items():
            avail.setdefault(k, v)
    new = dict(inputs)
    for k, v in inputs.items():
        cand = avail.get(k)
        if cand is not None and cand.shape == v.shape and cand.dtype == v.dtype:
            new[k] = cand
    return new


def run(proxy: Mapping[str, Any], seed: int, device: torch.device,
        precision: str = "float64") -> Tuple[Outputs, Choices]:
    """Every node's outputs of the proxy run from ``seed``."""
    outputs: Outputs = {}
    choices: Choices = {}
    for i, node in enumerate(proxy["nodes"]):
        mod = motif(node["motif"])
        p = params(node["p"])
        variant = variant_of(mod, node["variant"])
        inputs = mod.inputs(p, derive_seed(seed, i), device)
        if node["deps"]:
            upstream = [outputs[d] for d in node["deps"]]
            inputs = forward(inputs, upstream)
            eps = torch.zeros((), dtype=torch.float32, device=device)
            for out in upstream:
                eps = eps + checksum(out)
            inputs = perturb(inputs, eps)
        out, chosen = mod.apply(p, inputs, variant, precision)
        feed = inputs
        for _ in range(1, repeats(p)):
            out, chosen = mod.apply(p, feed, variant, precision)
            feed = perturb(feed, checksum(out))
        outputs[node["id"]], choices[node["id"]] = out, chosen
    return outputs, choices


def flops(proxy: Mapping[str, Any]) -> float:
    """Arithmetic of one run of the proxy: each node's invocation times
    its repeats (see each motif's ``flops``)."""
    total = 0.0
    for node in proxy["nodes"]:
        mod = motif(node["motif"])
        p = params(node["p"])
        total += mod.flops(p, variant_of(mod, node["variant"])) * repeats(p)
    return total


def products(proxy: Mapping[str, Any]) -> int:
    """Matrix products of one run of the proxy: each node's invocation
    times its repeats (a motif without ``products`` makes none)."""
    total = 0
    for node in proxy["nodes"]:
        mod = motif(node["motif"])
        count = getattr(mod, "products", None)
        if count is not None:
            p = params(node["p"])
            total += count(p, variant_of(mod, node["variant"])) * repeats(p)
    return total
