"""The run of a training cell, shared by the SR and classification kinds.

Set-up builds one trainer and its window step (`make_scan_train_step`,
the program's timed path), loads the seed's initial state (drawn on the
device by `harness.seeded_state`), and warms up: one window through every
pass key the run's sequence holds, which runs each key's part eagerly and
captures it. It then puts the seed's state back (the parameters and BN
statistics by `load_state_dict`, the optimizer's by its own
`load_state_dict` of its state before any step) and drives the same object
through the sequence's first three steps, by windows of one and two steps:
those are replays, the timed path itself. It reads each step's loss, the
first step's gradient as the optimizer took it (its state after one step)
and the parameters after the third. The measured window goes on from the
fourth step with the same object.

After the window the program is freed, and the plain reference runs the
same three steps from the same seed's state on the same inputs; the
numbers compared (`compare`) are the steps' losses, each leaf's first
gradient norm and each leaf's change after the three steps, each gap as a
share of the reference's.
"""

from __future__ import annotations

import copy
import gc
import math
import statistics
import time

import torch

from . import harness, roofline

CHECK_STEPS = 3
# a leaf whose reference gradient is under this share of the median leaf's
# is moved by round-off alone under Adam: left out of the change's gap
NOUGHT_SHARE = 1e-3
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tensors):
    """{name: float64 norm} of {name: tensor}, read back in one copy."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].detach().double().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def leaf_gaps(prog, ref, names):
    """Each leaf's |prog - ref| over max(ref, the median leaf's ref), over
    `names`; a leaf on one side only reads its other side's share."""
    scale = statistics.median(ref.values()) if ref else 1.0
    return [abs(prog.get(n, 0.0) - ref.get(n, 0.0)) / max(ref.get(n, 0.0), scale, 1e-30)
            for n in names]


def _worst(gaps):
    return math.inf if any(not math.isfinite(g) for g in gaps) else max(gaps, default=0.0)


def _median(gaps):
    return math.inf if any(not math.isfinite(g) for g in gaps) else statistics.median(gaps)


def compare(prog, ref):
    """[(name, value)] of the numbers a training cell may compare: the
    worst step's loss gap and the first step's, the worst and the median
    leaf's first-gradient gap, and the worst and the median leaf's change
    gap (leaves whose reference gradient is nought to rounding left out of
    the change; a leaf the reference leaves untouched must not move). A
    cell's limits file names the ones it compares."""
    losses = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
              for p, r in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad"], ref["grad"], set(prog["grad"]) | set(ref["grad"]))
    med = statistics.median(ref["grad"].values())
    moved = [n for n in set(prog["change"]) | set(ref["change"])
             if n not in ref["grad"] or ref["grad"][n] >= NOUGHT_SHARE * med]
    change = leaf_gaps(prog["change"], {n: ref["change"].get(n, 0.0) for n in moved}, moved)
    return [("loss_gap", _worst(losses)), ("loss1_gap", losses[0]),
            ("grad_gap", _worst(grad)), ("grad_median_gap", _median(grad)),
            ("change_gap", _worst(change)), ("change_median_gap", _median(change))]


def end_to_end(window):
    """The cell's end-to-end metrics from the untraced window."""
    return {"train_imgs_per_s": window["imgs"] / window["seconds"]}


class TrainRun:
    """A training cell's program side. A kind gives `build`, the sequence
    (`subnets(i)`: step i's K subnets as dicts; `batch(i)`; `lr(i)`), the
    number of its first steps that hold every pass key (`warmup_steps`),
    the program's subnet type (`arch`), the work
    (`calls`, `step_flops`) and the reference (`reference_readings`)."""

    def __init__(self, cell, cfg, traffic, seed, device="cuda"):
        self.cell, self.cfg, self.traffic, self.seed = cell, cfg, traffic, seed
        self.device = torch.device(device)
        self.k = traffic["subnets_per_step"]
        self.w = traffic["window_steps"]
        self.dtype = DTYPES[traffic["compute_dtype"]]
        self.b = 2 if self.dtype is torch.bfloat16 else 4
        self.setup_info = {}

    # -- the program ---------------------------------------------------------

    def args(self, first, n):
        steps = range(first, first + n)
        return ([self.batch(i) for i in steps],
                [[self.arch(s) for s in self.subnets(i)] for i in steps],
                [self.lr(i) for i in steps])

    def setup(self):
        t = time.perf_counter()
        self.build()
        self.shapes = harness.state_shapes(self.net)
        state0 = harness.seeded_state(self.shapes, self.seed, self.device)
        self.net.load_state_dict(state0)
        opt0 = copy.deepcopy(self.step.opt.state_dict())
        cache = self.step.cache
        sync(self.device)
        t0 = time.perf_counter()
        self.setup_info["build_s"] = t0 - t
        n_warm = self.warmup_steps()
        for at in range(0, n_warm, self.w):
            self.step(*self.args(at, min(self.w, n_warm - at)))
        sync(self.device)
        self.setup_info.update(warmup_s=time.perf_counter() - t0, captures=cache.captures,
                               capture_s=cache.capture_s)
        # the seed's state back, then the first steps through the replays
        self.net.load_state_dict(state0)
        self.step.opt.load_state_dict(opt0)
        self.restore_generators()
        out1 = self.step(*self.args(0, 1))
        first_grad = self.optimizer_grads()
        out23 = self.step(*self.args(1, CHECK_STEPS - 1))
        params = dict(self.net.named_parameters())
        self.prog = {"losses": out1["losses"].tolist() + out23["losses"].tolist(),
                     "grad": _norms(first_grad),
                     "change": _norms({n: params[n] - state0[n] for n in params})}
        del state0, first_grad
        self.setup_info["check_steps_s"] = time.perf_counter() - t0 - self.setup_info["warmup_s"]
        self.next_step = CHECK_STEPS
        self.captures_before_window = cache.captures

    def optimizer_grads(self):
        """{name: the first step's gradient as the optimizer took it}, from
        its state after that step (Adam: the first moment over 1 - beta1;
        SGD: the momentum buffer), for the parameters it stepped."""
        opt = self.step.opt
        sd = opt.state_dict()
        params = [p for g in opt.param_groups for p in g["params"]]
        names = {id(p): n for n, p in self.net.named_parameters()}
        adam = isinstance(opt.opt, torch.optim.Adam)
        b1 = opt.param_groups[0]["betas"][0] if adam else None
        out = {}
        for idx, st in sd["state"].items():
            name = names[id(params[idx])]
            out[name] = st["exp_avg"] / (1 - b1) if adam else st["momentum_buffer"]
        return out

    def restore_generators(self):
        """Put back any generator the program draws from (the dropout's)."""

    def window(self, seconds):
        """Windows of `window_steps` steps until `seconds` have passed, then
        a synchronise: the rate is over all the steps and all the time."""
        first = i = self.next_step
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        enqueue = 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            args = self.args(i, self.w)
            a = time.perf_counter()
            out = self.step(*args)
            enqueue += time.perf_counter() - a
            bad += (~torch.isfinite(out["losses"])).sum()
            i += self.w
        sync(self.device)
        dt = time.perf_counter() - t0
        self.next_step = i
        steps = i - first
        return {"seconds": dt, "steps": steps, "imgs": steps * self.traffic["batch"],
                "attempted": steps, "peak_flops": roofline.BF16_FLOPS if self.b == 2
                else roofline.TF32_FLOPS,
                "enqueue_s": enqueue, "failed": int(bad.item()),
                "flops": sum(self.step_flops(j) for j in range(first, i)),
                "captures_in_window": self.step.cache.captures - self.captures_before_window}

    def traced(self, n_windows):
        first = self.next_step

        def go():
            for _ in range(n_windows):
                self.step(*self.args(self.next_step, self.w))
                self.next_step += self.w

        _, trace = harness.trace_window(go, lambda: sync(self.device),
                                        self.device.type == "cuda")
        calls = [c for j in range(first, self.next_step) for c in self.calls(j)]
        return trace, calls

    def peak_bytes(self):
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("step", "trainer", "net", "teacher"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def reference32(self):
        if getattr(self, "_ref32", None) is None:
            self._ref32 = self.reference_readings("float32")
        return self._ref32

    def readings(self):
        """[(name, value)]: the program's numbers against the reference."""
        return compare(self.prog, self.reference32())

    def check(self, limits):
        """The numbers the cell's limits name, each beside its limit."""
        return [(n, v, limits[n]) for n, v in self.readings() if n in limits]

    def control(self):
        """The numbers of the reference computed one precision below the
        configuration's (fp8 for bf16, TF32 for float32), judged as the
        program is."""
        return compare(self.reference_readings(CONTROL[self.traffic["compute_dtype"]]),
                       self.reference32())
