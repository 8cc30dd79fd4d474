"""Host milliseconds a frame call takes before its synchronise: the host
clock around `StaticSubnet.__call__`, the mean over the untraced window's
frames."""

UNIT, BETTER = "ms", "lower"
LAYER = "serving path: entry.serve, models/materialize.py StaticSubnet"
MOVES = "frame_p95_ms"


def read(ctx):
    w = ctx.window
    if not w.get("frames"):
        return None
    return 1e3 * w["host_s"] / w["frames"]
