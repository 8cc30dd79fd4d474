"""Activations used by the SR nets (counterpart of
ofa_sr_tpu/ops/activations.py; the classification nets' h_swish family comes
with their slice)."""

from __future__ import annotations

import torch


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


ACT_FNS = {
    "relu6": relu6,
    None: lambda x: x,
    "none": lambda x: x,
}


def apply_act(x, act_func):
    return ACT_FNS[act_func](x)
