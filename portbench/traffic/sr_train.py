"""Kind `sr_train`: a progressive-shrinking phase of the SR supernet,
trained through `SRTrainer.make_scan_train_step` (the CUDA-graph window
step) with the phase's candidate lists.

The traffic file gives the phase: `ks_list`, `expand_list`, `depth_list`,
`pixel_d_list` (the candidates a subnet is drawn from), `subnets_per_step`
(the phase's dynamic batch size), `batch` HR patches of `hr_size` px (the
LR inputs their area averages), `compute_dtype`, the levers (`dw_switch`,
`expand_switch`), the optimizer with its `lr`, `window_steps` steps a
window and `batch_pool` distinct batches drawn from the seed.

Draws: each subnet's kernel sizes and expand ratios a block from Python's
`random` seeded with (seed, subnet index). Its stage depths and pixel_d,
which pick the program's pass graph, come from consecutive blocks of all
their combinations, each block in an order drawn from the seed: every
block holds each combination once, as a free draw does on average, so the
warm-up (one block) captures exactly the graphs the window replays and the
mix does not move from seed to seed.
"""

from __future__ import annotations

import itertools
import random

import torch
import torch.nn.functional as F

from .. import flops, harness, roofline, training
from ..reference import optim as ref_optim
from ..reference import sr as ref_sr
from ..reference.precision import DTYPES, ROUNDINGS

end_to_end = training.end_to_end


class Draw:
    """The subnet sequence of a seed: subnet j as {"ks", "e", "d", "pixel_d"}."""

    def __init__(self, cfg, traffic, seed):
        self.cfg, self.t, self.seed = cfg, traffic, seed
        self.n_blocks = cfg["n_stages"] * max(cfg["depth_list"])
        self.combos = [(d, pd) for d in itertools.product(traffic["depth_list"],
                                                          repeat=cfg["n_stages"])
                       for pd in traffic["pixel_d_list"]]
        self._blocks = {}

    def combo(self, j):
        blk, at = divmod(j, len(self.combos))
        if blk not in self._blocks:
            order = list(self.combos)
            random.Random("%d:order:%d" % (self.seed, blk)).shuffle(order)
            self._blocks[blk] = order
        return self._blocks[blk][at]

    def subnet(self, j):
        rng = random.Random("%d:subnet:%d" % (self.seed, j))
        ks = [rng.choice(self.t["ks_list"]) for _ in range(self.n_blocks)]
        e = [rng.choice(self.t["expand_list"]) for _ in range(self.n_blocks)]
        d, pd = self.combo(j)
        return {"ks": ks, "e": e, "d": list(d), "pixel_d": pd}


def make_batches(traffic, n, seed, device):
    """`n` batches of uniform [0, 1) HR patches with their LR inputs (area
    averages by 2^pixel_d), from one device generator."""
    b, hr = traffic["batch"], traffic["hr_size"]
    gen = torch.Generator(device=device).manual_seed(seed)
    hr_all = torch.rand(n, b, 3, hr, hr, generator=gen, device=device)
    out = []
    for i in range(n):
        x = hr_all[i]
        batch = {"image": x.permute(0, 2, 3, 1).contiguous()}
        for pd in traffic["pixel_d_list"]:
            batch["x%d" % 2 ** pd] = F.avg_pool2d(x, 2 ** pd).permute(0, 2, 3, 1).contiguous()
        out.append(batch)
    return out


class Workload(training.TrainRun):

    def __init__(self, cell, cfg, traffic, seed, device="cuda"):
        super().__init__(cell, cfg, traffic, seed, device)
        self.draw = Draw(cfg, traffic, seed)
        self.batches = make_batches(traffic, traffic["batch_pool"], seed + 1, self.device)

    # -- the sequence ----------------------------------------------------------

    def subnets(self, i):
        return [self.draw.subnet(i * self.k + j) for j in range(self.k)]

    def batch(self, i):
        return self.batches[i % len(self.batches)]

    def lr(self, i):
        return self.traffic["optimizer"]["lr"]

    def warmup_steps(self):
        """The steps of one block of the sequence: every (depths, pixel_d)
        combination, so every pass graph the run replays (the last step
        filled from the next block)."""
        return -(-len(self.draw.combos) // self.k)

    # -- the program -----------------------------------------------------------

    def build(self):
        from ofa_sr_tpu_torch.models.arch import SearchSpace, SubnetConfig
        from ofa_sr_tpu_torch.models.ofa_s4 import OFAMobileNetS4
        from ofa_sr_tpu_torch.train.train_step import SRTrainer
        c, t = self.cfg, self.traffic
        self._subnet_type = SubnetConfig
        space = SearchSpace(ks_list=c["ks_list"], expand_list=c["expand_list"],
                            depth_list=c["depth_list"], pixel_d_list=c["pixel_d_list"],
                            n_stages=c["n_stages"], width=c["width"])
        self.net = OFAMobileNetS4(space, device=self.device)
        self.net.train()
        opt = t["optimizer"]
        self.trainer = SRTrainer(self.net, opt_type=opt["type"],
                                 weight_decay=opt["weight_decay"], compute_dtype=self.dtype,
                                 dw_switch=t["dw_switch"], expand_switch=t["expand_switch"])
        self.step = self.trainer.make_scan_train_step(self.k)

    def arch(self, s):
        return self._subnet_type(ks=tuple(s["ks"]), e=tuple(s["e"]), d=tuple(s["d"]),
                                 pixel_d=s["pixel_d"])

    # -- the work --------------------------------------------------------------

    def calls(self, i):
        t = self.traffic
        return [c for s in self.subnets(i)
                for c in roofline.s4_train_calls(self.cfg, s, t["batch"], t["hr_size"], self.b,
                                                 expand_lever=t["expand_switch"])]

    def step_flops(self, i):
        """6 x the subnets' forward MACs over the batch: 2 a MAC forward, 4
        backward."""
        hr = self.traffic["hr_size"]
        return 6 * self.traffic["batch"] * sum(
            flops.s4_subnet_macs(self.cfg, s, hr, hr) for s in self.subnets(i))

    # -- the reference ---------------------------------------------------------

    def reference_readings(self, precision):
        """The first three steps by the plain reference from the seed's
        state, in `precision` ("float32", or the control's "fp8" or
        "tf32"): each step's loss, each leaf's first gradient norm and its
        change after the three."""
        state0 = harness.seeded_state(self.shapes, self.seed, self.device)
        expected = set(ref_sr.param_shapes(self.cfg))
        if expected != set(state0):
            raise RuntimeError("the reference's and the program's state differ: %s"
                               % sorted(expected ^ set(state0))[:8])
        rounding = ROUNDINGS[precision]
        net = ref_sr.S4(self.cfg, state0, rounding,
                        dtype=DTYPES.get(precision, torch.float32))
        named = net.named_parameters()

        def loss_of_step(i):
            losses = []
            for s in self.subnets(i):
                loss = ref_sr.train_loss(net, self.batch(i), s)
                loss.backward()
                losses.append(loss.detach())
            return torch.stack(losses).mean()

        losses, grad, params = ref_optim.run_steps(
            named, loss_of_step, training.CHECK_STEPS,
            [self.lr(i) for i in range(training.CHECK_STEPS)], self.traffic["optimizer"])
        return {"losses": losses, "grad": training._norms(grad),
                "change": training._norms({n: params[n] - state0[n] for n in params})}
