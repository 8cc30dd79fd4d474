"""The activation zoo of the reference's build_activation (counterpart of
ofa_sr_tpu/ops/activations.py): relu6 for the SR nets, the h_swish family
for the classification nets. The pixel (un)shuffle "activations" are wired
at the layer level (ops/pixelshuffle.py)."""

from __future__ import annotations

import torch


def relu(x):
    return torch.clamp(x, min=0.0)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def h_swish(x):
    """x * relu6(x + 3) / 6."""
    return x * relu6(x + 3.0) / 6.0


def h_sigmoid(x):
    """relu6(x + 3) / 6."""
    return relu6(x + 3.0) / 6.0


def lrelu(x):
    """LeakyReLU(0.1)."""
    return torch.where(x >= 0, x, 0.1 * x)


ACT_FNS = {
    "relu": relu,
    "relu6": relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "h_swish": h_swish,
    "h_sigmoid": h_sigmoid,
    "lrelu": lrelu,
    None: lambda x: x,
    "none": lambda x: x,
}


def apply_act(x, act_func):
    return ACT_FNS[act_func](x)
