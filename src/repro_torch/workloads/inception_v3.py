"""TensorFlow Inception-V3 in PyTorch (CPU-intensive; ILSVRC2012 images);
port of ``repro/workloads/inception_v3.py``.

The reference's module structure at its reduced spatial scale: 75x75x3
images, batch 32 — stem (3x3 convs), two Inception-A blocks (1x1 /
5x5-as-3x3 / double-3x3 / pool-proj branches), a grid reduction, and the
head (global avgpool -> dropout -> fc -> softmax).

The head's dropout draws from the ``rng`` seed leaf: :func:`step` draws
the keep mask and :func:`step_with_keep` applies a given one, so a test
can hand over the reference's own mask.  The 3x3 stride-2 max pool pads
as JAX's ``"SAME"`` does, with -inf and asymmetrically (38 -> 19 pads
(0, 1)); the 3x3 average pool pads zeros and divides by 9, on a
contiguous copy of its input (:func:`_avgpool3` says why).

Paper Table III motifs: Matrix (fully connected, softmax), Sampling
(max/avg pooling, dropout), Logic (ReLU), Transform (convolution),
Statistics (batch normalization).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.decompose import MotifHint
from repro_torch.core.motifs.transform import conv2d, pad_same
from repro_torch.data.generators import (DataSpec, gen_images, gen_seed,
                                         generator_from)
from repro_torch.workloads.alexnet import batchnorm, cross_entropy, sgd_step
from repro_torch.workloads.base import Workload, register_workload

NUM_CLASSES = 100
BATCH = 32
IMG = 75
KEEP = 0.8


def init_params(gen: torch.Generator) -> Dict[str, torch.Tensor]:
    def conv(kh, kw, cin, cout):  # OIHW
        return torch.randn(cout, cin, kh, kw, generator=gen,
                           device=gen.device) / math.sqrt(kh * kw * cin)

    p = {"stem1": conv(3, 3, 3, 32), "stem2": conv(3, 3, 32, 64)}
    # two inception-A blocks at 64 -> 128 channels
    cin = 64
    for b in range(2):
        p[f"a{b}_1x1"] = conv(1, 1, cin, 32)
        p[f"a{b}_5x5_r"] = conv(1, 1, cin, 24)
        p[f"a{b}_5x5a"] = conv(3, 3, 24, 32)
        p[f"a{b}_5x5b"] = conv(3, 3, 32, 32)
        p[f"a{b}_3x3_r"] = conv(1, 1, cin, 32)
        p[f"a{b}_3x3a"] = conv(3, 3, 32, 48)
        p[f"a{b}_pool_p"] = conv(1, 1, cin, 16)
        cin = 32 + 32 + 48 + 16  # 128
    # grid reduction
    p["red_3x3"] = conv(3, 3, cin, 96)
    # head
    p["fc"] = torch.randn(96 + cin, NUM_CLASSES, generator=gen,
                          device=gen.device) / math.sqrt(96.0)
    p["fc_b"] = torch.zeros(NUM_CLASSES, device=gen.device)
    return p


def head_width(params) -> int:
    """Features entering the head's dropout and fc."""
    return params["fc"].shape[0]


def _bn_relu(x):
    return torch.relu(batchnorm(x))


def _avgpool3(x):
    # on a contiguous copy: torch 2.11's CUDA avg_pool2d backward is wrong
    # for a channels-last input (the images' NCHW view and what the convs
    # make of it), off by as much as the gradient itself; the forward and
    # the CPU are right either way
    return F.avg_pool2d(x.contiguous(), 3, stride=1, padding=1,
                        count_include_pad=True)


def _maxpool(x):
    return F.max_pool2d(pad_same(x, (3, 3), 2, value=-math.inf), 3, 2)


def _inception_a(p, b, x):
    br1 = _bn_relu(conv2d(x, p[f"a{b}_1x1"]))
    br2 = _bn_relu(conv2d(x, p[f"a{b}_5x5_r"]))
    br2 = _bn_relu(conv2d(br2, p[f"a{b}_5x5a"]))
    br2 = _bn_relu(conv2d(br2, p[f"a{b}_5x5b"]))
    br3 = _bn_relu(conv2d(x, p[f"a{b}_3x3_r"]))
    br3 = _bn_relu(conv2d(br3, p[f"a{b}_3x3a"]))
    br4 = _bn_relu(conv2d(_avgpool3(x), p[f"a{b}_pool_p"]))
    return torch.cat([br1, br2, br3, br4], dim=1)


def forward(params, images, keep):
    x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW view
    x = _bn_relu(conv2d(x, params["stem1"], stride=2))
    x = _bn_relu(conv2d(x, params["stem2"]))
    x = _maxpool(x)
    x = _inception_a(params, 0, x)
    x = _inception_a(params, 1, x)
    # grid reduction: strided conv branch || maxpool branch
    r1 = _bn_relu(conv2d(x, params["red_3x3"], stride=2, padding="VALID"))
    r2 = _maxpool(x)[:, :, : r1.shape[2], : r1.shape[3]]
    x = torch.cat([r1, r2], dim=1)
    # head: global average pool -> dropout -> fc
    x = torch.mean(x, dim=(2, 3))
    x = torch.where(keep, x / KEEP, torch.zeros_like(x))
    return x @ params["fc"] + params["fc_b"]


def loss_fn(params, images, labels, keep):
    return cross_entropy(forward(params, images, keep), labels)


def make_inputs(gen: torch.Generator, scale: float = 1.0):
    batch = max(int(BATCH * scale), 4)
    images = gen_images(gen, batch, IMG, IMG, 3, "NHWC",
                        DataSpec(distribution="normal"))
    labels = torch.randint(0, NUM_CLASSES, (batch,), generator=gen,
                           device=gen.device, dtype=torch.int32)
    return (init_params(gen), images, labels, gen_seed(gen))


def step_with_keep(params, images, labels, keep, lr: float = 0.01):
    """One SGD step with the head's dropout keep mask given."""
    return sgd_step(loss_fn, params, images, labels, keep, lr=lr)


def keep_mask(params, images, rng) -> torch.Tensor:
    """The head dropout's keep mask, drawn from the ``rng`` seed leaf."""
    gen = generator_from(rng)
    return torch.rand((images.shape[0], head_width(params)), generator=gen,
                      device=gen.device) < KEEP


def step(params, images, labels, rng, lr: float = 0.01):
    return step_with_keep(params, images, labels,
                          keep_mask(params, images, rng), lr=lr)


HINTS = (
    MotifHint("transform", "conv2d", 0.50),
    MotifHint("matrix", "fully_connected", 0.15),
    MotifHint("sampling", "avgpool", 0.10),
    MotifHint("logic", "relu", 0.10),
    MotifHint("statistics", "batchnorm", 0.15),
)

INCEPTION_V3 = register_workload(Workload(
    name="inception_v3",
    make_inputs=make_inputs,
    step=step,
    hints=HINTS,
    input_axes=(None, "batch", "batch", None),
))
