"""The train-mode BN forward and backward: the least time of the work the
traced window's subnets need (portbench/roofline.py) over the device time
of the family's kernels there, by function name from torch.profiler. None
where none ran."""

UNIT, BETTER = "%", "higher"
LAYER = "BN kernels: ops/kernels/bn_stats.py, csrc/bn_stats.cu"
MOVES = "train_imgs_per_s"


def read(ctx):
    return ctx.roofline_pct("bn")
