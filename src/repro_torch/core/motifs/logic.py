"""Logic motif — bit-manipulation computation (port of
``repro/core/motifs/logic.py``).

Paper Table III implementations covered:
* ``bitops``  (xor/and/shift mix — the generic bit-manipulation unit)
* ``relu``    (the paper files Inception's ReLU under Logic)
* ``crc``     (rolling xor-shift checksum over chunks, a scan)

uint32 arithmetic wraps mod 2^32 in the reference.  CUDA torch has no
uint32 ``bitwise_xor`` or multiply, so each step runs on the int64
widening of the words and is masked back to 32 bits wherever it could
leave them; results are ``torch.uint32`` again.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.motifs.base import Motif, PVector, chunked, register
from repro_torch.data.generators import gen_keys, gen_vectors, make_generator
from repro_torch.device import resolve_device
from repro_torch.uint32 import narrow, widen

_M32 = 0xFFFFFFFF


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of int64 ``x`` over its last dim, by halving (torch has no XOR
    reduction); an odd length XORs its last column in first."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x[..., :-2], x[..., -2:-1] ^ x[..., -1:]], -1)
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


@register
class LogicMotif(Motif):
    name = "logic"
    variants = ("bitops", "relu", "crc")
    default_variant = "bitops"
    tunable = ("data_size", "chunk_size", "num_tasks", "weight")
    data_kind = "bits"

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        gen = make_generator(seed, resolve_device(device))
        bits = gen_keys(gen, int(p.data_size), p.spec())
        dim = 256
        acts = gen_vectors(gen, max(int(p.data_size) // dim, 4), dim, p.spec())
        return {"bits": bits, "acts": acts}

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        v = self.resolve_variant(variant)
        if v == "relu":
            y = torch.clamp_min(inputs["acts"], 0)
            return {"y": y,
                    "active_frac": torch.mean((y > 0).to(torch.float32))}

        bits = inputs["bits"]
        if v == "bitops":
            # shifts through bitwise_right_shift, the op ``>>`` names:
            # on a DTensor, torch 2.13's ``__rshift__`` returns its input
            shr = torch.bitwise_right_shift
            x = widen(bits)  # int64 words in [0, 2^32)
            x = x ^ shr(x, 13)
            x = (x * 0x5BD1E995) & _M32  # < 2^63: no int64 overflow
            x = x ^ shr(x, 15)
            x = x | 1
            # popcount via SWAR
            c = x - (shr(x, 1) & 0x55555555)
            c = (c & 0x33333333) + (shr(c, 2) & 0x33333333)
            c = (c + shr(c, 4)) & 0x0F0F0F0F
            pop = shr((c * 0x01010101) & _M32, 24)
            return {"hashed": narrow(x, bits.dtype),
                    "popcount": narrow(torch.sum(pop) & _M32, bits.dtype)}

        # crc: per-task sequential xor-shift scan over chunks, one step a
        # chunk for every task at once
        words = xor_reduce(widen(chunked(p, bits)))  # (tasks, per)
        acc = torch.zeros_like(words[:, 0])
        hs = []
        for j in range(words.shape[1]):
            acc = ((acc * 31) & _M32) ^ words[:, j]
            hs.append(acc)
        return {"crc": narrow(torch.stack(hs, 1), bits.dtype)}
