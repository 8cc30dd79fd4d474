"""The masked 1x1 expand and project convs, each direction bounded by the
sampled width (bytes or bf16 operations, whichever bounds): the least time
of the work the traced window's subnets need (portbench/roofline.py) over
the device time of the family's kernels there, by function name from
torch.profiler. None where none ran."""

UNIT, BETTER = "%", "higher"
LAYER = "masked 1x1: ops/kernels/pw_masked.py, csrc/pw_masked.cu"
MOVES = "train_imgs_per_s"


def read(ctx):
    return ctx.roofline_pct("pw_masked")
