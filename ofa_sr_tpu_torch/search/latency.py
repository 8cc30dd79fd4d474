"""Latency lookup tables and their measurement on the device (counterpart of
ofa_sr_tpu/search/latency.py).

- `LatencyTable`: the reference's key format ('expanded_conv-input:...'),
  ms values, saved as JSON and read from JSON or flat 'key: value' YAML:
  a table written by either package loads in the other.
- `measure_latency`: the end-to-end per-call wall (eager calls, synchronized).
- `measure_latency_device`: the device time of one call. The JAX package
  chains n calls inside one `lax.scan` dispatch so the host's per-call cost
  drops out; here n back-to-back calls are captured in one CUDA graph and
  replayed between two CUDA events. Both take the slope between an
  `n_small` and an `n_big` window, so the constant per-window cost cancels.
- `build_latency_table` (whole uniform subnets) and
  `build_block_latency_table` (one entry per MBConv (ks, e) and resolution,
  plus a head/tail remainder per pixel_d) measure the port's materialized
  subnets: on a CUDA net every block entry is one launch of the MBConv
  kernel a call, every whole subnet sum(d) of them and, on the S4,
  pixel_d launches of the shuffle-tail kernel.
- `lut_efficiency_fn`: a subnet's ms summed from the block table, the
  efficiency constraint of `EvolutionFinder`.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.arch import uniform_subnet
from ..models.materialize import get_active_subnet


class LatencyTable:
    """Key format of the reference query keys, e.g.
    'expanded_conv-input:56x56x24-output:56x56x24-expand:3-kernel:3'. Values
    are latency in ms. Backed by a plain dict loaded from JSON or YAML."""

    def __init__(self, table: Optional[dict] = None, path: Optional[str] = None):
        if table is None and path is not None:
            table = _load_table(path)
        self.table = table or {}

    @staticmethod
    def repr_shape(shape):
        if isinstance(shape, (list, tuple)):
            return "x".join(str(s) for s in shape)
        return str(shape)

    def key(self, l_type: str, input_shape, output_shape, **kwargs):
        infos = ["%s" % l_type,
                 "input:%s" % self.repr_shape(input_shape),
                 "output:%s" % self.repr_shape(output_shape)]
        infos += ["%s:%s" % (k, v) for k, v in kwargs.items() if v is not None]
        return "-".join(infos)

    def query(self, l_type: str, input_shape, output_shape, **kwargs):
        return self.table[self.key(l_type, input_shape, output_shape, **kwargs)]

    def set(self, l_type, input_shape, output_shape, latency_ms, **kwargs):
        self.table[self.key(l_type, input_shape, output_shape, **kwargs)] = latency_ms

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.table, f, indent=2)


def _load_table(path):
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        # minimal YAML (flat 'key: value' lines) without a yaml dependency
        table = {}
        for line in text.splitlines():
            if ":" in line and not line.strip().startswith("#"):
                k, _, v = line.rpartition(":")
                try:
                    table[k.strip()] = float(v)
                except ValueError:
                    pass
        return table


def _sync(args):
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)


def measure_latency(fn: Callable, *args, warmup=3, iters=20):
    """Median wall-clock ms of one eager call of `fn(*args)`, the device
    synchronized after each: the end-to-end per-call number, host cost
    included. For the device time use `measure_latency_device`."""
    times = []
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        _sync(args)
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            _sync(args)
            times.append((time.perf_counter() - t0) * 1000)
    return float(np.median(times))


def _cuda_window(fn, x, n):
    """A function timing one replay, in seconds between two CUDA events, of
    a CUDA graph of n back-to-back calls of fn(x); captured after a warm-up
    on a side stream, replayed once before it is timed."""
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(x)
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn(x)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed():
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return timed


def _host_window(fn, x, n):
    """A function timing n back-to-back calls of fn(x) on the host clock (a
    CPU tensor: the caller asked for the CPU)."""
    fn(x)

    def timed():
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        return time.perf_counter() - t0
    return timed


def measure_latency_device(fn: Callable, x, n_small=16, n_big=48, reps=3,
                           min_signal_s=0.02, max_rounds=3):
    """Device-compute latency of `fn(x)` in ms: the slope of the best-of-
    `reps` window times between `n_small` and `n_big` back-to-back calls.

    On a CUDA tensor a window is one replay of a CUDA graph that holds its
    n calls, timed with CUDA events: the host's per-call cost is out of it,
    as in the JAX package's scan-amortized timing. The graph records each
    call's launches once, when it is captured, so a kernel wrapper's launch
    counter counts the captured calls (and the warm-up's), not the
    replays. On a CPU tensor a window is n eager calls on the host clock.

    Adaptive, as in the JAX package: if the two windows differ by less than
    `min_signal_s`, both grow (by 2-16x) and are measured again, up to
    `max_rounds` times; a slope that is still not positive raises rather
    than putting a free block into a latency table."""
    window = _cuda_window if x.device.type == "cuda" else _host_window
    with torch.no_grad():
        for round_i in range(max_rounds):
            walls = {}
            for n in (n_small, n_big):
                timed = window(fn, x, n)
                walls[n] = min(timed() for _ in range(reps))
                del timed
            signal = walls[n_big] - walls[n_small]
            if signal >= min_signal_s:
                return signal / (n_big - n_small) * 1000
            if round_i == max_rounds - 1:
                if signal <= 0:
                    raise RuntimeError(
                        "measure_latency_device: no usable slope after %d adaptive rounds "
                        "(signal %.6f s at n=%d/%d)" % (max_rounds, signal, n_small, n_big))
                return signal / (n_big - n_small) * 1000
            # cap the per-round jump, so that one low signal does not grow
            # the next windows into minutes of work
            scale = min(16, max(2, int(np.ceil(min_signal_s * 1.5 / max(signal, 1e-4)))))
            n_small, n_big = n_small * scale, n_big * scale


def filter_slope_samples(samples, *, floor_ms=0.0, max_spread=3.0):
    """Drop non-physical slope samples: a non-positive slope (the small
    window outran the big one: a hiccup in the harness), and a sample
    further than `max_spread`x from the median of the positive ones (a
    jitter outlier). Pure function; returns (kept, rejected), both sorted."""
    pos = [s for s in samples if s > floor_ms]
    rejected = [s for s in samples if s <= floor_ms]
    if not pos:
        return [], sorted(rejected)
    med = float(np.median(pos))
    lo, hi = med / max_spread, med * max_spread
    kept = [s for s in pos if lo <= s <= hi]
    rejected += [s for s in pos if not (lo <= s <= hi)]
    return sorted(kept), sorted(rejected)


def select_slope_vs_wall(slopes, walls, *, lo_frac=0.6):
    """Pick the best slope-timed step given the amortized walls (a window's
    wall over its steps). The wall already dilutes the constant per-window
    cost, so the true step cannot sit below ~`lo_frac`x the smallest wall;
    a slope under that is window-pair variance. Returns (best_ms, ok_slopes,
    rejected_slopes); the smallest wall, an upper bound on the step, when
    every slope is rejected. Pure function."""
    walls = sorted(walls)
    slopes = sorted(slopes)
    ok = [t for t in slopes if t > lo_frac * walls[0]]
    rejected = [t for t in slopes if t not in ok]
    best = ok[0] if ok else walls[0]
    return best, ok, rejected


def sample_slopes(window_fn, *, n_small, n_big, reps=3, max_attempts=None,
                  floor_ms=0.0, max_spread=3.0):
    """Collect `reps` guarded slope samples from paired timing windows.

    `window_fn(k)` = ms of k chained calls. One sample = (window_fn(n_big) -
    window_fn(n_small)) / (n_big - n_small). Non-physical samples
    (`filter_slope_samples`) are resampled, up to `max_attempts` (default
    2*reps+2) pairs in all; raises if none survives. Returns (kept,
    rejected) in ms, both sorted."""
    if max_attempts is None:
        max_attempts = 2 * reps + 2
    raw = []
    kept, rejected = [], []
    for _ in range(max_attempts):
        t_small = window_fn(n_small)
        t_big = window_fn(n_big)
        raw.append((t_big - t_small) / (n_big - n_small))
        kept, rejected = filter_slope_samples(raw, floor_ms=floor_ms, max_spread=max_spread)
        if len(kept) >= reps:
            break
    if not kept:
        raise RuntimeError(
            "sample_slopes: all %d slope samples were non-physical (%s)"
            % (len(raw), [round(s, 3) for s in raw]))
    return kept, rejected


def _rand(rng, shape, device):
    """rng.rand(*shape) as a float32 tensor on `device` (the JAX package's
    `jnp.asarray(rng.rand(...), jnp.float32)`)."""
    return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)


def build_latency_table(net, space, hr_size=96, batch_size=1, iters=10, device_timing=True):
    """Measure each uniform subnet corner (ks, e, d, pixel_d), materialized
    on the net's device, and record it as an 'sr_subnet' entry.
    `device_timing=True` records `measure_latency_device`; False the
    per-call wall of `measure_latency`."""
    table = LatencyTable()
    rng = np.random.RandomState(0)
    for pd in space.pixel_d_list:
        lr = hr_size // (2 ** pd)
        x = _rand(rng, (batch_size, lr, lr, 3), net.device)
        for k in space.ks_list:
            for e in space.expand_list:
                for d in space.depth_list:
                    cfg = uniform_subnet(space, k, e, d, pd, n_trunks=net.n_trunks)
                    sub = get_active_subnet(net, cfg)
                    if device_timing:
                        ms = measure_latency_device(sub, x)
                    else:
                        ms = measure_latency(sub, x, warmup=2, iters=iters)
                    table.set("sr_subnet", [lr, lr, 3], [hr_size, hr_size, 3], ms,
                              kernel=k, expand=e, depth=d, pixel_d=pd)
    return table


def build_block_latency_table(net, space, hr_size=96, batch_size=1, trunk_stages=None):
    """Additive per-layer latency table: one 'expanded_conv' entry per
    (kernel, expand) at each pixel_d's LR resolution, timing one MBConv
    block of a materialized subnet, plus one 'sr_head_tail' entry per
    pixel_d for everything outside the trunk (stem, final convs, shuffle
    stages), the whole minimal subnet's time less its blocks' sum.

    latency(cfg) ~= head_tail[pd] + sum over blocks blk[ks_i, e_i, res(pd)];
    the sum is approximate, callers spot-check it. The subnets are
    materialized in 'sr' mode, which runs `space.n_stages` stages on both
    nets (the S4's trunk, the X4's decoder): the default `trunk_stages`."""
    table = LatencyTable()
    rng = np.random.RandomState(0)
    w = space.width
    d_min, d_max = min(space.depth_list), max(space.depth_list)
    n_stages_total = trunk_stages if trunk_stages is not None else space.n_stages
    for pd in space.pixel_d_list:
        lr = hr_size // (2 ** pd)
        xb = _rand(rng, (batch_size, lr, lr, w), net.device)
        blk_ms = {}
        for k in space.ks_list:
            for e in space.expand_list:
                cfg = uniform_subnet(space, k, e, d_max, pd, n_trunks=net.n_trunks)
                sub = get_active_subnet(net, cfg)
                bp = sub.params["dec_stages"][0][0]
                ms = measure_latency_device(lambda t, bp=bp, sub=sub: sub._mbconv(bp, t), xb)
                blk_ms[(k, e)] = ms
                table.set("expanded_conv", [lr, lr, w], [lr, lr, w], ms, kernel=k, expand=e)
        # head + tail: the whole minimal subnet less its blocks' sum
        k0, e0 = min(space.ks_list), min(space.expand_list)
        cfg = uniform_subnet(space, k0, e0, d_min, pd, n_trunks=net.n_trunks)
        sub = get_active_subnet(net, cfg)
        x = _rand(rng, (batch_size, lr, lr, 3), net.device)
        whole = measure_latency_device(sub, x)
        ht = max(whole - n_stages_total * d_min * blk_ms[(k0, e0)], 0.0)
        table.set("sr_head_tail", [lr, lr, 3], [hr_size, hr_size, 3], ht, pixel_d=pd)
    return table


def lut_efficiency_fn(table: LatencyTable, space, hr_size=96, n_trunks=1, stage_range=None):
    """cfg -> estimated latency in ms from an additive per-block table
    (`build_block_latency_table`): the efficiency constraint of
    `EvolutionFinder`.

    `stage_range=(lo, hi)` restricts the billed stages (cfg.d indices).
    Default: the last trunk's stages, the ones 'sr' mode runs (the S4's
    only trunk, the X4's decoder); encoder genes cost nothing there."""
    w = space.width
    lo_s, hi_s = stage_range or (space.n_stages * (n_trunks - 1), space.n_stages * n_trunks)

    def fn(cfg):
        lr = hr_size // (2 ** cfg.pixel_d)
        ms = table.query("sr_head_tail", [lr, lr, 3], [hr_size, hr_size, 3],
                         pixel_d=cfg.pixel_d)
        for si in range(lo_s, hi_s):
            for i in range(cfg.d[si]):
                bi = si * space.max_depth + i
                ms += table.query("expanded_conv", [lr, lr, w], [lr, lr, w],
                                  kernel=cfg.ks[bi], expand=cfg.e[bi])
        return ms
    return fn
