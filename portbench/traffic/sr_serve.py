"""Kind `sr_serve`: one client sending LR frames in a closed loop to a
materialized subnet, as `entry.serve` answers them (`get_active_subnet`,
then `StaticSubnet.__call__` a frame under `torch.inference_mode`).

The traffic file gives the `subnet` ({"ks", "e", "d", "pixel_d"}, one
value for every block and stage), the LR frame's `lr_h` x `lr_w`, the
`frame_pool` distinct frames drawn from the seed (uniform [0, 1)), sent
in turn, and `trace_frames`, the frames of the traced window. Each frame
is timed from its submission until its output is on the device and
synchronised.

The answers checked are the last `frame_pool` of the window, one for each
frame of the pool, against the plain reference's eval forward of the same
subnet from the same seed's state (BN from its running statistics, not
folded). The control is that reference with every product's operands
rounded to TF32.
"""

from __future__ import annotations

import gc
import itertools
import math
import time

import torch

from .. import flops, harness, roofline
from ..reference import sr as ref_sr
from ..reference.precision import ROUNDINGS


def p95(values):
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(window):
    return {"frame_p95_ms": 1e3 * p95(window["latencies"])}


def frame_gap(out, ref):
    """The largest |out - ref| over the reference frame's largest magnitude."""
    return float((out.float() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


class Workload:

    def __init__(self, cell, cfg, traffic, seed, device="cuda"):
        self.cell, self.cfg, self.traffic, self.seed = cell, cfg, traffic, seed
        self.device = torch.device(device)
        t = traffic
        n_blocks = cfg["n_stages"] * max(cfg["depth_list"])
        s = t["subnet"]
        self.subnet = {"ks": [s["ks"]] * n_blocks, "e": [s["e"]] * n_blocks,
                       "d": [s["d"]] * cfg["n_stages"], "pixel_d": s["pixel_d"]}
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.frames = list(torch.rand(t["frame_pool"], 1, t["lr_h"], t["lr_w"], 3,
                                      generator=gen, device=self.device))
        self.answers = {}
        self.setup_info = {}
        self.macs = flops.s4_subnet_macs(cfg, self.subnet, t["lr_h"] * 2 ** s["pixel_d"],
                                         t["lr_w"] * 2 ** s["pixel_d"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        from ofa_sr_tpu_torch.models.arch import SearchSpace, SubnetConfig
        from ofa_sr_tpu_torch.models.materialize import get_active_subnet
        from ofa_sr_tpu_torch.models.ofa_s4 import OFAMobileNetS4
        c, s = self.cfg, self.subnet
        space = SearchSpace(ks_list=c["ks_list"], expand_list=c["expand_list"],
                            depth_list=c["depth_list"], pixel_d_list=c["pixel_d_list"],
                            n_stages=c["n_stages"], width=c["width"])
        net = OFAMobileNetS4(space, device=self.device)
        self.shapes = harness.state_shapes(net)
        net.load_state_dict(harness.seeded_state(self.shapes, self.seed, self.device))
        self.serve = get_active_subnet(net, SubnetConfig(ks=tuple(s["ks"]), e=tuple(s["e"]),
                                                         d=tuple(s["d"]), pixel_d=s["pixel_d"]))
        del net
        t0 = time.perf_counter()
        with torch.inference_mode():
            for x in self.frames[:2]:  # the one frame shape: kernels loaded, cuDNN's plans
                self.serve(x)
        self.sync()
        self.setup_info["warmup_s"] = time.perf_counter() - t0

    def _frames(self, first, n, record):
        lat, host = [], 0.0
        pool = len(self.frames)
        with torch.inference_mode():
            for i in range(first, first + n) if n else itertools.count(first):
                x = self.frames[i % pool]
                a = time.perf_counter()
                y = self.serve(x)
                b = time.perf_counter()
                self.sync()
                lat.append(time.perf_counter() - a)
                host += b - a
                self.answers[i % pool] = y
                if record and record(len(lat)):
                    break
        return lat, host

    def window(self, seconds):
        t0 = time.perf_counter()
        lat, host = self._frames(0, 0, lambda n: time.perf_counter() - t0 >= seconds)
        dt = time.perf_counter() - t0
        self.next_frame = len(lat)
        return {"seconds": dt, "frames": len(lat), "attempted": len(lat), "failed": 0,
                "latencies": lat, "host_s": host, "flops": 2.0 * self.macs * len(lat),
                "peak_flops": roofline.TF32_FLOPS}

    def traced(self, n_windows):
        n = self.traffic["trace_frames"]
        _, trace = harness.trace_window(lambda: self._frames(self.next_frame, n, None),
                                        self.sync, self.device.type == "cuda")
        self.next_frame += n
        t = self.traffic
        return trace, roofline.s4_serve_calls(self.cfg, self.subnet, t["lr_h"], t["lr_w"]) * n

    def peak_bytes(self):
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def release(self):
        self.serve = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def reference_gap(self, answers):
        """The widest frame gap of `answers` ({pool index: frame}) from the
        float32 reference, or (`answers` None) the control's: the reference
        with every product's operands rounded to TF32."""
        state = harness.seeded_state(self.shapes, self.seed, self.device)
        net = ref_sr.S4(self.cfg, state, requires_grad=False)
        control = ref_sr.S4(self.cfg, state, rounding=ROUNDINGS["tf32"], requires_grad=False)
        worst = 0.0
        with torch.no_grad():
            for j in sorted(answers if answers is not None else range(len(self.frames))):
                ref = net.forward(self.frames[j], self.subnet, train=False)
                out = (answers[j] if answers is not None
                       else control.forward(self.frames[j], self.subnet, train=False))
                gap = frame_gap(out, ref)
                if not math.isfinite(gap):
                    return math.inf
                worst = max(worst, gap)
        return worst

    def readings(self):
        answers, self.answers = self.answers, {}
        return [("frame_gap", self.reference_gap(answers))]

    def check(self, limits):
        return [(n, v, limits[n]) for n, v in self.readings() if n in limits]

    def answer_all(self):
        """An answer for every frame of the pool (a check without a window)."""
        self._frames(0, len(self.frames), None)

    def control(self):
        return [("frame_gap", self.reference_gap(None))]
