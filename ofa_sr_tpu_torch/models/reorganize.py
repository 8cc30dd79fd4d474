"""Channel-importance reorganization before the elastic-expand stages, and
the last-gamma zero init (counterpart of ofa_sr_tpu/models/reorganize.py,
the reference's `re_organize_middle_weights`).

Sort an MBConv block's middle channels by the L1 importance of the project
conv's weights (the sum of |w| over its output channels and taps), and
permute, in place, the expand conv's output channels, the depthwise bank,
both their BNs (weights, biases, running statistics) and the project conv's
input channels to that order. With `expand_ratio_stage` > 0 the channels
past round(width * the stage's expand ratio, largest first) are forced to
the bottom in their order (importance 0, -1, -2, ...), so widths already
shrunk keep their channels.

The permutation writes each parameter's storage in place: the parameters
stay the objects the optimizer holds, and its state (Adam's moments) keeps
its old channel order, as the JAX package keeps `opt_state` and the
reference permutes `.data`. The importance is summed by numpy over the
JAX package's HWIO layout of the project bank, and sorted stably, so both
packages pick the same order.
"""

from __future__ import annotations

import numpy as np
import torch


def _importance_order(layer, space, expand_ratio_stage: int = 0):
    """The middle channels of a DynamicMBConvLayer, most important first."""
    w = layer.point_linear.conv.weight.detach().float().cpu().numpy()  # [out, mid, 1, 1]
    hwio = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
    importance = np.abs(hwio).sum(axis=(0, 1, 3)).astype(np.float64)
    if expand_ratio_stage > 0:
        desc = sorted(space.expand_list, reverse=True)
        target = round(space.width * desc[min(expand_ratio_stage, len(desc) - 1)])
        n = importance.shape[0]
        importance[target:] = np.arange(0, -(n - target), -1)
    return np.argsort(-importance, kind="stable")


def _permute_(t, idx, dim):
    t.copy_(t.index_select(dim, idx))


def reorganize_mbconv(layer, space, expand_ratio_stage: int = 0):
    """Permute one DynamicMBConvLayer's middle channels in place; returns
    the order (numpy indices into the old channels)."""
    order = _importance_order(layer, space, expand_ratio_stage)
    idx = torch.from_numpy(order).to(layer.point_linear.conv.weight.device)
    with torch.no_grad():
        for part in (layer.inverted_bottleneck, layer.depth_conv):
            _permute_(part.conv.weight, idx, 0)  # the kernel-transform matrices are per tap
            bn = part.bn
            for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
                _permute_(t, idx, 0)
        _permute_(layer.point_linear.conv.weight, idx, 1)
    return order


def _reorganize_trunks(blocks, space, expand_ratio_stage):
    return [reorganize_mbconv(b.mobile_inverted_conv, space, expand_ratio_stage)
            for b in blocks]


def reorganize_s4(net, expand_ratio_stage: int = 0):
    """Every MBConv block of an OFAMobileNetS4, in place; returns the
    orders."""
    return _reorganize_trunks(net.dec_blocks, net.space, expand_ratio_stage)


def reorganize_x4(net, expand_ratio_stage: int = 0):
    """Every MBConv block of both trunks of an OFAMobileNetX4, in place (the
    unshuffle and shuffle convs are outside the trunks); returns the
    orders, encoder first."""
    return _reorganize_trunks(net.enc_blocks + net.dec_blocks, net.space, expand_ratio_stage)


def zero_last_gamma(net):
    """Zero, in place, the project BN's scale of every MBConv block (each
    has the identity shortcut in the SR nets): the residual-branch zero
    init the reference nets define and never call."""
    with torch.no_grad():
        for b in getattr(net, "enc_blocks", []) + net.dec_blocks:
            b.mobile_inverted_conv.point_linear.bn.weight.zero_()
