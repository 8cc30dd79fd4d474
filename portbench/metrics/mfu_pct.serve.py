"""The whole frame's share of the card's peak: 2 x the subnet's MACs a
frame (portbench/flops.py) x the frames a second of the untraced window,
against the TF32 dense peak, 495 TFLOP/s: float32 products may run as
TF32 splits on the tensor cores, and no float32 frame can pass that
rate."""

UNIT, BETTER = "%", "higher"
LAYER = "serving path: entry.serve, models/materialize.py StaticSubnet"
MOVES = "frame_p95_ms"


def read(ctx):
    w = ctx.window
    if not w.get("seconds") or not w.get("flops"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / w["peak_flops"]
