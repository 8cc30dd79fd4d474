"""Scalar helpers that define the elastic-channel and elastic-kernel geometry.

Counterpart of ofa_sr_tpu/utils/common.py (a copy, so the port never imports
the JAX package). Any deviation changes which weights a subnet sees.
"""

from __future__ import annotations


def make_divisible(v, divisor, min_val=None):
    """Round `v` to the nearest multiple of `divisor`, never going below 90%.

    Used for the elastic middle-channel counts
    `make_divisible(round(in_ch * expand_ratio), 8)`.
    """
    if min_val is None:
        min_val = divisor
    new_v = max(min_val, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def get_same_padding(kernel_size):
    """SAME padding for an odd kernel: k // 2 per side."""
    if isinstance(kernel_size, tuple):
        assert len(kernel_size) == 2, "invalid kernel size: %s" % str(kernel_size)
        return get_same_padding(kernel_size[0]), get_same_padding(kernel_size[1])
    assert isinstance(kernel_size, int), "kernel size should be either `int` or `tuple`"
    assert kernel_size % 2 > 0, "kernel size should be odd number"
    return kernel_size // 2


def sub_filter_start_end(kernel_size, sub_kernel_size):
    """Start/end indices of the centered k x k window inside a K x K kernel,
    e.g. (7, 3) -> (2, 5)."""
    center = kernel_size // 2
    dev = sub_kernel_size // 2
    start, end = center - dev, center + dev + 1
    assert end - start == sub_kernel_size
    return start, end


def int2list(val, repeat_time=1):
    """Broadcast a scalar to a list (or pass a list/tuple through as a list)."""
    if isinstance(val, list):
        return val
    elif isinstance(val, tuple):
        return list(val)
    else:
        return [val for _ in range(repeat_time)]


class AverageMeter:
    """Running average (the reference's AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
