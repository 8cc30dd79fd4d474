"""Closed-form MACs and parameter counts of S4 subnets, and the per-block
FLOPs table (counterpart of ofa_sr_tpu/search/flops.py).

Numpy and plain Python only: the same integers as the JAX package for the
same subnet. The reference counts MACs (weight-ops per position) and calls
the field 'flops'; so do both packages. `cls_subnet_flops`, the
classification nets' count, waits for the port of those nets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.arch import SearchSpace, SubnetConfig


def _conv_macs(h, w, cin, cout, k, groups=1):
    return h * w * (cin // groups) * cout * k * k


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree


def count_params(tree):
    """Elements of the tensors (and numpy arrays) of a nested dict/list, such
    as a `StaticSubnet.params`, or of an `nn.Module`'s parameters and
    buffers. Unlike the JAX package's `jax.tree.leaves` count, scalars in the
    tree (a block's "ks" and "mid") are not counted."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters()) + list(tree.buffers())
    return sum(int(np.prod(np.shape(t))) for t in _leaves(tree))


def s4_subnet_params(cfg: SubnetConfig, space: SearchSpace, conv_ks=5):
    """Parameter count of a materialized S4 subnet: every conv weight and
    each BN's scale and bias (not its running statistics)."""
    w = space.width
    p = conv_ks * conv_ks * 3 * w + 2 * w  # first conv + BN
    bi = 0
    for si in range(space.n_stages):
        for i in range(space.max_depth):
            if i < cfg.d[si]:
                mid = space.mid_channels(cfg.e[bi])
                k = cfg.ks[bi]
                p += w * mid + 2 * mid            # ib + BN
                p += k * k * mid + 2 * mid        # dw + BN
                p += mid * w + 2 * w              # pl + BN
            bi += 1
    p += 2 * (conv_ks * conv_ks * w * w + 2 * w)  # final convs
    for _ in range(cfg.pixel_d):
        p += conv_ks * conv_ks * w * (4 * w) + 2 * (4 * w)
    p += conv_ks * conv_ks * w * 3 + 2 * 3
    return p


def s4_subnet_flops(cfg: SubnetConfig, space: SearchSpace, hr_size=96, conv_ks=5):
    """MACs of one forward of a materialized S4 subnet at the given HR output
    size (input = hr / 2^pixel_d). `hr_size` is an int (square) or an
    (H, W) tuple."""
    w = space.width
    hr_h, hr_w = (hr_size, hr_size) if isinstance(hr_size, int) else hr_size
    lh, lw = hr_h // (2 ** cfg.pixel_d), hr_w // (2 ** cfg.pixel_d)
    f = _conv_macs(lh, lw, 3, w, conv_ks)
    bi = 0
    for si in range(space.n_stages):
        for i in range(space.max_depth):
            if i < cfg.d[si]:
                mid = space.mid_channels(cfg.e[bi])
                k = cfg.ks[bi]
                f += _conv_macs(lh, lw, w, mid, 1)
                f += _conv_macs(lh, lw, mid, mid, k, groups=mid)
                f += _conv_macs(lh, lw, mid, w, 1)
            bi += 1
    f += 2 * _conv_macs(lh, lw, w, w, conv_ks)
    hh, ww = lh, lw
    for _ in range(cfg.pixel_d):
        f += _conv_macs(hh, ww, w, 4 * w, conv_ks)
        hh *= 2
        ww *= 2
    f += _conv_macs(hh, ww, w, 3, conv_ks)
    return f


def mbconv_macs(space: SearchSpace, lr, k, e):
    """MACs of one MBConv block (expand, depthwise, project) at an lr x lr
    input."""
    mid, w = space.mid_channels(e), space.width
    return (_conv_macs(lr, lr, w, mid, 1) + _conv_macs(lr, lr, mid, mid, k, groups=mid)
            + _conv_macs(lr, lr, mid, w, 1))


class FLOPsTable:
    """The closed form above, with each (pixel_d, ks, e) block's MACs
    precomputed, for an O(1) `predict_efficiency`."""

    def __init__(self, space: SearchSpace, hr_size=96, conv_ks=5):
        self.space = space
        self.hr_size = hr_size
        self.conv_ks = conv_ks
        self._block_macs = {
            (pd, k, e): mbconv_macs(space, hr_size // (2 ** pd), k, e)
            for pd in space.pixel_d_list for k in space.ks_list for e in space.expand_list}

    def predict_efficiency(self, cfg: SubnetConfig):
        sp = self.space
        lr = self.hr_size // (2 ** cfg.pixel_d)
        w, ck = sp.width, self.conv_ks
        f = _conv_macs(lr, lr, 3, w, ck)
        bi = 0
        for si in range(sp.n_stages):
            for i in range(sp.max_depth):
                if i < cfg.d[si]:
                    f += self._block_macs[(cfg.pixel_d, cfg.ks[bi], cfg.e[bi])]
                bi += 1
        f += 2 * _conv_macs(lr, lr, w, w, ck)
        hw = lr
        for _ in range(cfg.pixel_d):
            f += _conv_macs(hw, hw, w, 4 * w, ck)
            hw *= 2
        f += _conv_macs(hw, hw, w, 3, ck)
        return f
