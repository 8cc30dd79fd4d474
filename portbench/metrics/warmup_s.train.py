"""Seconds of set-up spent in the warm-up windows: each pass key's eager
first run and capture, the teacher's and the update's (host clock, ended
by a synchronise). The captures and their seconds (`GraphCache.captures`,
`.capture_s`) go on the run's `setup` line, with the captures made in the
window."""

UNIT, BETTER = "s", "lower"
LAYER = "window step: train/graphs.py WindowStep through make_scan_train_step"
MOVES = "setup_s"


def read(ctx):
    return ctx.setup.get("warmup_s")
