"""Statistics motif — fundamental statistical units of computation (port
of ``repro/core/motifs/statistics.py``).

Paper Table III implementations covered:
* ``count`` / ``average``  (K-means cluster count + mean update)
* ``degree``               (PageRank out/in-degree counting)
* ``batchnorm``            (AlexNet / Inception batch normalization)
* ``softmax``              (Inception-V3 head)

``jax.ops.segment_sum`` becomes ``bincount`` / ``index_add_``; counts
stay int32 as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.motifs.base import (Motif, PVector, chunked, register,
                                          segment_count)
from repro_torch.data.generators import (gen_graph, gen_images, gen_vectors,
                                         make_generator)
from repro_torch.device import resolve_device


@register
class StatisticsMotif(Motif):
    name = "statistics"
    variants = ("count", "average", "degree", "batchnorm", "softmax")
    default_variant = "average"
    tunable = ("data_size", "chunk_size", "num_tasks", "weight",
               "batch_size", "channels")
    data_kind = "mixed"

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        gen = make_generator(seed, resolve_device(device))
        dim = max(min(int(p.chunk_size), 1024), 8)
        rows = max(int(p.data_size) // dim, 8)
        x = gen_vectors(gen, rows, dim, p.spec())
        labels = (torch.randint(0, 1 << 32, (rows,), generator=gen,
                                device=gen.device)
                  % max(p.channels, 2)).to(torch.int32)
        v = max(int(p.data_size) // 64, 16)
        src, dst = gen_graph(gen, v, int(max(p.data_size, 256)), p.spec())
        images = gen_images(gen, max(p.batch_size, 1), p.height, p.width,
                            p.channels, p.layout, p.spec())
        return {"x": x, "labels": labels, "src": src, "dst": dst,
                "images": images}

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        v = self.resolve_variant(variant)
        x = inputs["x"]

        if v == "count":
            return {"counts": segment_count(inputs["labels"],
                                             max(p.channels, 2))}

        if v == "average":
            # per-task chunked running mean/var (Welford-like combine)
            xc = chunked(p, x)  # (tasks, per, chunk, dim)
            s = torch.sum(xc, dim=(1, 2))
            s2 = torch.sum(torch.square(xc), dim=(1, 2))
            n = xc.shape[1] * xc.shape[2]
            mean = torch.sum(s, dim=0) / (n * xc.shape[0])
            var = torch.sum(s2, dim=0) / (n * xc.shape[0]) - torch.square(mean)
            return {"mean": mean, "var": var}

        if v == "degree":
            nv = max(int(p.data_size) // 64, 16)  # matches make_inputs
            in_deg = segment_count(inputs["dst"], nv)
            return {"out_deg": segment_count(inputs["src"], nv),
                    "in_deg": in_deg, "max_in": torch.amax(in_deg)}

        if v == "batchnorm":
            img = inputs["images"]
            axes = (0, 1, 2) if p.layout == "NHWC" else (0, 2, 3)
            mean = torch.mean(img, dim=axes, keepdim=True)
            var = torch.var(img, dim=axes, keepdim=True, correction=0)
            return {"y": (img - mean) * torch.rsqrt(var + 1e-5)}

        # softmax over the feature dim
        return {"probs": torch.softmax(x.to(torch.float32), dim=-1).to(x.dtype)}
