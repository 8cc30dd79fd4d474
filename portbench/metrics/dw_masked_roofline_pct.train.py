"""The masked depthwise's forward, dgrad and wgrad over the sampled taps and
widths: the least time of the work the traced window's subnets need
(portbench/roofline.py) over the device time of the family's kernels
there, by function name from torch.profiler. None where none ran."""

UNIT, BETTER = "%", "higher"
LAYER = "masked depthwise: ops/kernels/dw_masked.py, csrc/dw_masked.cu"
MOVES = "train_imgs_per_s"


def read(ctx):
    return ctx.roofline_pct("dw_masked")
