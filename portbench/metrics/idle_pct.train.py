"""Share of the traced window in which no operation ran on the device
(kernels, copies, sets), from torch.profiler's trace: 100 x (1 - busy_s /
window_s)."""

UNIT, BETTER = "%", "lower"
LAYER = "device: H100"
MOVES = "train_imgs_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.window_s or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
