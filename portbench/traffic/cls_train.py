"""Kind `cls_train`: a progressive-shrinking phase of a classification
supernet, trained through `ClsTrainer.make_scan_train_step` (the
CUDA-graph window step) with KD from a teacher.

The traffic file gives the phase: `ks_list`, `expand_list`, `depth_list`,
`subnets_per_step`, `batch` images of one of `image_sizes` a step and
`n_classes` labels, `label_smoothing`, `kd_ratio` and the `teacher`'s
kernel size, expand ratio and depth (its weights from the seed),
`compute_dtype`, `dw_switch`, the optimizer with its `lr`,
`window_steps`, and `batch_pool` batches a size drawn from the seed
(normal images, uniform labels).

Draws: each subnet's kernel sizes, expand ratios (a block) and depths (a
stage) from Python's `random` seeded with (seed, subnet index). The image
size a step comes from consecutive runs of len(image_sizes) steps, each
run holding every size once in an order drawn from the seed: the published
mix of sizes, with none of a free draw's spread between runs. The pass
graphs are keyed by the batch's shape alone (the depths are device gates),
so the warm-up is one run of sizes: a teacher graph and a pass graph a
size, and the update.
"""

from __future__ import annotations

import random

import torch

from .. import flops, harness, roofline, training
from ..reference import cls as ref_cls
from ..reference import optim as ref_optim
from ..reference.precision import DTYPES, ROUNDINGS

end_to_end = training.end_to_end


class Workload(training.TrainRun):

    def __init__(self, cell, cfg, traffic, seed, device="cuda"):
        super().__init__(cell, cfg, traffic, seed, device)
        t = traffic
        self.n_blocks = sum(s[4] for s in cfg["stages"])
        self.sizes = t["image_sizes"]
        self.dropout_seed = seed + 3
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.batches = {}
        for r in self.sizes:
            img = torch.randn(t["batch_pool"], t["batch"], r, r, 3, generator=gen,
                              device=self.device)
            lab = torch.randint(0, t["n_classes"], (t["batch_pool"], t["batch"]), generator=gen,
                                device=self.device)
            self.batches[r] = [{"image": img[i], "label": lab[i]} for i in range(t["batch_pool"])]
        self.teacher_arch = {"ks": [t["teacher"]["ks"]] * self.n_blocks,
                             "e": [t["teacher"]["e"]] * self.n_blocks,
                             "d": [t["teacher"]["d"]] * len(cfg["stages"])}

    # -- the sequence ----------------------------------------------------------

    def size(self, i):
        run, at = divmod(i, len(self.sizes))
        order = list(self.sizes)
        random.Random("%d:sizes:%d" % (self.seed, run)).shuffle(order)
        return order[at]

    def subnets(self, i):
        out = []
        for j in range(i * self.k, (i + 1) * self.k):
            rng = random.Random("%d:subnet:%d" % (self.seed, j))
            t = self.traffic
            out.append({"ks": [rng.choice(t["ks_list"]) for _ in range(self.n_blocks)],
                        "e": [rng.choice(t["expand_list"]) for _ in range(self.n_blocks)],
                        "d": [rng.choice(t["depth_list"]) for _ in self.cfg["stages"]]})
        return out

    def batch(self, i):
        pool = self.batches[self.size(i)]
        return pool[(i // len(self.sizes)) % len(pool)]

    def lr(self, i):
        return self.traffic["optimizer"]["lr"]

    def warmup_steps(self):
        """One run of sizes: every pass and teacher graph the run replays."""
        return len(self.sizes)

    # -- the program -----------------------------------------------------------

    def build(self):
        from ofa_sr_tpu_torch.models import ofa_cls
        from ofa_sr_tpu_torch.train.cls_trainer import ClsTrainer
        c, t = self.cfg, self.traffic
        self._arch_type = ofa_cls.ClsArch
        make = getattr(ofa_cls, c["model"])
        common = dict(n_classes=c["n_classes"], width_mult=c["width_mult"],
                      dropout_rate=c["dropout_rate"], bn_momentum=c["bn_momentum"],
                      bn_eps=c["bn_eps"], device=self.device)
        self.net = make(ks_list=c["ks_list"], expand_list=c["expand_list"],
                        depth_list=c["depth_list"], **common)
        te = t["teacher"]
        self.teacher = make(ks_list=[te["ks"]], expand_list=[te["e"]], depth_list=[te["d"]],
                            **common)
        self.teacher_shapes = harness.state_shapes(self.teacher)
        self.teacher.load_state_dict(harness.seeded_state(self.teacher_shapes, self.seed + 2,
                                                          self.device))
        opt = t["optimizer"]
        self.trainer = ClsTrainer(
            self.net, opt_type=opt["type"], weight_decay=opt["weight_decay"],
            momentum=opt["momentum"], nesterov=opt["nesterov"],
            label_smoothing=t["label_smoothing"], kd_ratio=t["kd_ratio"], kd_type="ce",
            teacher=(self.teacher, self.teacher.max_arch()), compute_dtype=self.dtype,
            dropout_seed=self.dropout_seed, dw_switch=t["dw_switch"])
        self.step = self.trainer.make_scan_train_step(self.k)

    def restore_generators(self):
        self.trainer.dropout_generator.manual_seed(self.dropout_seed)

    def arch(self, s):
        return self._arch_type(ks=tuple(s["ks"]), e=tuple(s["e"]), d=tuple(s["d"]))

    # -- the work --------------------------------------------------------------

    def calls(self, i):
        r, b = self.size(i), self.traffic["batch"]
        return [c for s in self.subnets(i)
                for c in roofline.cls_train_calls(self.cfg, s, b, r, self.b)]

    def step_flops(self, i):
        """6 x the subnets' forward MACs and 2 x the teacher's, over the
        batch."""
        r, b = self.size(i), self.traffic["batch"]
        return b * (6 * sum(flops.cls_subnet_macs(self.cfg, s, r) for s in self.subnets(i))
                    + 2 * flops.cls_subnet_macs(self.cfg, self.teacher_arch, r))

    # -- the reference ---------------------------------------------------------

    def reference_readings(self, precision):
        c, t = self.cfg, self.traffic
        state0 = harness.seeded_state(self.shapes, self.seed, self.device)
        expected = set(ref_cls.param_shapes(c))
        if expected != set(state0):
            raise RuntimeError("the reference's and the program's state differ: %s"
                               % sorted(expected ^ set(state0))[:8])
        te = t["teacher"]
        teacher = ref_cls.Classifier(
            c, harness.seeded_state(self.teacher_shapes, self.seed + 2, self.device),
            requires_grad=False, ks_list=[te["ks"]], expand_list=[te["e"]],
            depth_list=[te["d"]])
        net = ref_cls.Classifier(c, state0, ROUNDINGS[precision],
                                 dtype=DTYPES.get(precision, torch.float32))
        gen = torch.Generator(device=self.device).manual_seed(self.dropout_seed)
        keep = 1.0 - c["dropout_rate"]

        def loss_of_step(i):
            batch = self.batch(i)
            with torch.no_grad():
                soft = torch.softmax(teacher.forward(batch["image"], self.teacher_arch, False), -1)
            losses = []
            for s in self.subnets(i):
                mask = torch.rand((t["batch"], c["feature_mix_width"]), generator=gen,
                                  device=self.device) < keep
                logits = net.forward(batch["image"], s, True, dropout=mask)
                loss = (t["kd_ratio"] * ref_cls.kd_loss(logits, soft)
                        + ref_cls.cross_entropy(logits, batch["label"], t["label_smoothing"]))
                loss.backward()
                losses.append(loss.detach())
            return torch.stack(losses).mean()

        losses, grad, params = ref_optim.run_steps(
            net.named_parameters(), loss_of_step, training.CHECK_STEPS,
            [self.lr(i) for i in range(training.CHECK_STEPS)], t["optimizer"])
        return {"losses": losses, "grad": training._norms(grad),
                "change": training._norms({n: params[n] - state0[n] for n in params})}
