"""Host milliseconds a training step takes to enqueue: the host clock
around each window call, before its synchronise, over the steps it
covers, in the untraced window."""

UNIT, BETTER = "ms", "lower"
LAYER = "window step: train/graphs.py WindowStep through make_scan_train_step"
MOVES = "train_imgs_per_s"


def read(ctx):
    w = ctx.window
    if not w.get("steps") or "enqueue_s" not in w:
        return None
    return 1e3 * w["enqueue_s"] / w["steps"]
