"""TensorFlow AlexNet in PyTorch (CPU+memory-intensive; CIFAR-10 images);
port of ``repro/workloads/alexnet.py``.

The paper trains the CIFAR-10 AlexNet variant (TensorFlow tutorial model):
conv5x5(64) -> pool -> conv5x5(64) -> pool -> fc384 -> fc192 -> fc10, with
batch normalization, batch size 128, 32x32x3 images.  One step = forward +
backward (``torch.autograd.grad``) + SGD, returning ``(new_params, loss)``.

Images are NHWC, as in the reference; the network runs on their NCHW view
with OIHW conv weights (``repro_torch.convert.params_from_reference``
carries the reference's HWIO ones across) and flattens in NHWC order, so
fc1's rows are (h, w, c) as in the reference.  The whole step runs in full
f32 (:func:`repro_torch.device.full_f32`).

Paper Table III motifs: Matrix (fully connected), Sampling (max pooling),
Transform (convolution), Statistics (batch normalization).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.decompose import MotifHint
from repro_torch.core.motifs.transform import conv2d
from repro_torch.data.generators import DataSpec, gen_images
from repro_torch.device import full_f32
from repro_torch.distributed.spmd import (batch_sum, is_dtensor,
                                         replicate_dims, replicated)
from repro_torch.workloads.base import Workload, register_workload

NUM_CLASSES = 10
BATCH = 128
IMG = 32


def init_params(gen: torch.Generator) -> Dict[str, torch.Tensor]:
    dev = gen.device

    def conv(kh, kw, cin, cout):  # OIHW
        return torch.randn(cout, cin, kh, kw, generator=gen,
                           device=dev) / math.sqrt(kh * kw * cin)

    def dense(din, dout):
        return torch.randn(din, dout, generator=gen, device=dev) / math.sqrt(din)

    def ones(n):
        return torch.ones(n, device=dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    flat = (IMG // 4) * (IMG // 4) * 64
    return {
        "conv1": conv(5, 5, 3, 64),
        "conv2": conv(5, 5, 64, 64),
        "bn1_scale": ones(64), "bn1_bias": zeros(64),
        "bn2_scale": ones(64), "bn2_bias": zeros(64),
        "fc1": dense(flat, 384), "b1": zeros(384),
        "fc2": dense(384, 192), "b2": zeros(192),
        "fc3": dense(192, NUM_CLASSES), "b3": zeros(NUM_CLASSES),
    }


def batchnorm(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` normalised per channel over (N, H, W), population
    variance.  A batch-sharded (DTensor) ``x`` takes its statistics as
    two means (each an all-reduce of partial averages), where the fused
    ``var_mean`` would gather the whole batch."""
    if is_dtensor(x):
        x = replicate_dims(x, (1, 2, 3))
        n = x.shape[0] * x.shape[2] * x.shape[3]
        mean = batch_sum(x, (0, 2, 3)) / n
        var = batch_sum(torch.square(x - mean), (0, 2, 3)) / n
    else:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), keepdim=True,
                                   correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def forward(params, images):
    x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW view
    x = torch.relu(conv2d(x, params["conv1"]))
    x = F.max_pool2d(x, 2, 2)
    x = (batchnorm(x) * _per_channel(params["bn1_scale"])
         + _per_channel(params["bn1_bias"]))
    x = torch.relu(conv2d(x, params["conv2"]))
    x = (batchnorm(x) * _per_channel(params["bn2_scale"])
         + _per_channel(params["bn2_bias"]))
    x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
    x = torch.relu(x @ params["fc1"] + params["b1"])
    x = torch.relu(x @ params["fc2"] + params["b2"])
    return x @ params["fc3"] + params["b3"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.to(torch.int64)[:, None]))


def loss_fn(params, images, labels):
    return cross_entropy(forward(params, images), labels)


def make_inputs(gen: torch.Generator, scale: float = 1.0):
    batch = max(int(BATCH * scale), 8)
    images = gen_images(gen, batch, IMG, IMG, 3, "NHWC",
                        DataSpec(distribution="normal"))
    labels = torch.randint(0, NUM_CLASSES, (batch,), generator=gen,
                           device=gen.device, dtype=torch.int32)
    return (init_params(gen), images, labels)


def sgd_step(loss_fn, params, *args, lr: float = 0.01):
    """``(params - lr * grad, loss)`` of ``loss_fn(params, *args)``, in full
    f32.  Under a mesh each gradient is made whole (the data-parallel
    gradient all-reduce) before it updates its replicated parameter."""
    with full_f32():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = loss_fn(leaves, *args)
        grads = torch.autograd.grad(loss, tuple(leaves.values()))
    grads = tuple(replicated(g) for g in grads)
    with torch.no_grad():
        new = {k: p - lr * g for (k, p), g in zip(params.items(), grads)}
    return new, loss.detach()


def step(params, images, labels, lr: float = 0.01):
    return sgd_step(loss_fn, params, images, labels, lr=lr)


HINTS = (
    MotifHint("transform", "conv2d", 0.45),
    MotifHint("matrix", "fully_connected", 0.25),
    MotifHint("sampling", "maxpool", 0.10),
    MotifHint("statistics", "batchnorm", 0.20),
)

ALEXNET = register_workload(Workload(
    name="alexnet",
    make_inputs=make_inputs,
    step=step,
    hints=HINTS,
    input_axes=(None, "batch", "batch"),
))
