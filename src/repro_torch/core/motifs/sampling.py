"""Sampling motif — select a subset of data by a statistical rule (port of
``repro/core/motifs/sampling.py``).

Paper Table III implementations covered:
* ``random`` / ``interval``  (TeraSort partitioner sampling)
* ``maxpool`` / ``avgpool``  (AlexNet / Inception pooling)
* ``dropout``                (Inception-V3)
* ``topk``                   (MoE-router sampling)

The reference's PRNG key leaf ``rng`` is a 0-d int32 seed here
(:func:`gen_seed`); random, dropout and topk draw from the generator it
names, so only their distributions match the reference's.  Pooling
returns NHWC, as the reference does, whatever the input layout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.motifs.base import Motif, PVector, register
from repro_torch.data.generators import (gen_images, gen_keys, gen_seed,
                                         gen_vectors, generator_from,
                                         make_generator)
from repro_torch.device import resolve_device
from repro_torch.uint32 import narrow, take, widen


@register
class SamplingMotif(Motif):
    name = "sampling"
    variants = ("random", "interval", "maxpool", "avgpool", "dropout", "topk")
    default_variant = "random"
    tunable = ("data_size", "chunk_size", "num_tasks", "weight",
               "batch_size", "height", "width", "channels")
    data_kind = "mixed"

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        gen = make_generator(seed, resolve_device(device))
        return {
            "keys": gen_keys(gen, int(p.data_size), p.spec()),
            "rng": gen_seed(gen),
            # image inputs sized by the AI fields of P
            "images": gen_images(gen, max(p.batch_size, 1), p.height,
                                 p.width, p.channels, p.layout, p.spec()),
        }

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        v = self.resolve_variant(variant)
        keys = inputs["keys"]
        n = keys.shape[0]

        if v == "random":
            m = max(n // 64, 1)
            gen = generator_from(inputs["rng"])
            idx = torch.randint(0, n, (m,), generator=gen, device=gen.device)
            sample = take(keys, idx)
            # partitioner use: sorted sample -> split points
            splits = narrow(torch.sort(widen(sample)).values, keys.dtype)
            return {"splits": splits[:: max(m // 16, 1)]}

        if v == "interval":
            stride = max(int(p.chunk_size) % 97 + 2, 2)
            return {"sample": keys[::stride]}

        if v == "topk":
            scores = gen_vectors(generator_from(inputs["rng"]),
                                 n // max(p.channels, 1) + 1,
                                 max(p.channels, 2), p.spec())
            vals, idx = torch.topk(scores, k=min(2, scores.shape[-1]), dim=-1)
            return {"vals": vals, "idx": idx.to(torch.int32)}

        x = inputs["images"]
        if p.layout == "NCHW":
            x = x.permute(0, 2, 3, 1)
        if v == "dropout":
            gen = generator_from(inputs["rng"])
            keep = torch.rand(x.shape, generator=gen, device=gen.device) < 0.5
            return {"y": torch.where(keep, x * 2.0, torch.zeros_like(x))}

        # pooling: 2x2 window stride 2 (the AlexNet/Inception shape), on the
        # NCHW view of the NHWC data, returned NHWC
        pool = F.max_pool2d if v == "maxpool" else F.avg_pool2d
        y = pool(x.permute(0, 3, 1, 2), kernel_size=2, stride=2)
        return {"y": y.permute(0, 2, 3, 1)}
