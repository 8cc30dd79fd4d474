"""The fused MBConv inference kernel (both 1x1 convs as 3xTF32 on the tensor
cores at 495 TFLOP/s, the depthwise on the CUDA cores at 67): the least
time of the traced frames' work (bytes at 3.35 TB/s or operations,
whichever bounds; portbench/roofline.py) over the device time of its
kernel there. None where it did not run."""

UNIT, BETTER = "%", "higher"
LAYER = "serving kernels: ops/kernels/mbconv.py, ops/kernels/shuffle_tail.py"
MOVES = "frame_p95_ms"


def read(ctx):
    return ctx.roofline_pct("mbconv")
