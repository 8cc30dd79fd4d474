"""Multi-step training as CUDA-graph replays: the port's form of the JAX
package's `jit` + `lax.scan` (`SRTrainer.make_scan_train_step`,
ofa_sr_tpu/train/train_step.py:258-327, and `ClsTrainer.make_scan_train_step`,
ofa_sr_tpu/train/cls_trainer.py:154-219), which has no module of its own
to name there.

A window of N optimizer steps runs each step as
`[teacher] + K x [subnet pass] + [update]` (`WindowStep`, the part both
trainers share):
- a subnet pass is the masked forward of one subnet, its loss and metrics,
  and its backward, whose gradients accumulate in place into the
  optimizer's static flat gradient buffer (each parameter's `.grad` a view
  of it); the subnet's device form is read from one static int32 buffer,
  `arch`: the SR nets' kernel-size indices and middle widths
  (`SRWindowStep`, with `MaskedArch`), a classification net's
  `arch_vector` (`ClsWindowStep`, with `device_arch`);
- the teacher is the KD teacher's eval forward into a static output;
- the update is `GatedOpt.update`, gated by the step's touched flags and
  lr, read from static device buffers, zeroing the gradients after.
Between replays the host only copies device to device: the next batch into
the static inputs, the next subnet's row into `arch` and the next step's
(touched, lr) from the window's buffers, uploaded once a window from pinned
memory, and each pass's metrics out into the window's.

`GraphCache` keeps one graph per key: an SR pass by (mode, depths, pixel_d,
compute_dtype, batch shapes, frozen BN, KD, the net's depthwise lever); a
classification pass by ("cls", batch shapes, compute_dtype, frozen BN, KD,
the lever), its depths being device gates; the teacher by its input's
shape, and the one update. The lever is set once with the trainer, and
the masked depthwise reads each subnet's kernel size and width from
`arch`: it adds no key a subnet. The first time a key comes up, its part
of the step runs eagerly on the cache's stream (the real step, and the
warm-up that capture needs), and is then captured without executing, so
no step updates the parameters or running statistics twice. All graphs
share one memory pool: nothing a graph allocates outlives its replay (its
outputs go into buffers allocated outside the pool, held for the run's
life), so the graphs can be replayed
in any order. A generator that a captured function draws from (the
classification trainer's dropout generator) is registered with every graph
(`register_generator`), so each replay draws the generator's next numbers,
as an eager call would: capture advances no generator, and a replay
advances it by what its kernels draw. On a CPU net the same code runs
eagerly, part by part: the CPU tests' path.

Under a mesh (the trainer's `mesh`, data parallelism; each rank passes
its rows of every batch, the same subnets, touched masks and lrs) the
window has the eager step's global-batch semantics, with its collectives
inside the parts that issue them:
- every train-mode BN of a pass all-reduces its column totals each way
  (the BN wrappers' `group`), inside the pass's graph;
- the update first sums the flat gradient buffer over the ranks and
  divides it by the world size (`train_step.average_gradients`), then
  clips and steps, inside the update's graph;
- each pass keeps this rank's parts of the metrics (the SR loss and the
  sum and count of its squared Y errors; the classification loss, top-1
  and top-5), and one all-reduce a window, after the last replay, makes
  them the global batch's.
On a CUDA net the graphs capture NCCL's collectives: the communicator is
made by the first eager run of a key that issues one, before any capture.
A CUDA net under a group whose collectives cannot be captured (gloo, which
copies through the host) raises ValueError when the window step is made,
before anything runs. On a CPU net, over gloo, every part runs eagerly.

A wrapper's launch counter counts the eager first run and the capture of
each graph, not its replays.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.arch import MaskedArch
from ..parallel.mesh import all_reduce_sum, capturable, world_size
from ..utils.metrics import psnr_from_mse
from .optim import GatedOpt
from .touched import cls_touched_mask, sr_touched_mask


class GraphCache:
    """Captured CUDA graphs by key, all in one memory pool, on one side
    stream (`stream`), with counts of captures and replays and the seconds
    spent capturing. On a CPU device `run` calls its function."""

    def __init__(self, device):
        self.device = device
        self.graphs = {}
        self.generators = []
        self.captures = self.replays = 0
        self.capture_s = 0.0
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()

    def register_generator(self, generator):
        """Register a CUDA `torch.Generator` that captured functions draw
        from with every graph captured from now on: each replay then draws
        its next numbers (a generator of another device has nothing to
        register)."""
        if generator.device.type == "cuda":
            self.generators.append(generator)

    def run(self, key, fn):
        """Replay the graph of `key`; the first time, run `fn` eagerly (the
        real work) and capture it."""
        if not self.cuda:
            fn()
            return
        g = self.graphs.get(key)
        if g is not None:
            g.replay()
            self.replays += 1
            return
        fn()
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        t0 = time.perf_counter()
        g.capture_begin(pool=self.pool)
        try:
            fn()
        except BaseException:
            try:
                g.capture_end()
            except RuntimeError:
                pass  # the capture is invalid already; report fn's error
            raise
        g.capture_end()
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.graphs[key] = g


def _pinned(a, device):
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class WindowStep:
    """A window of optimizer steps through the graph cache (the module
    docstring): the part the SR and classification window steps share.
    A subclass gives the subnet's `arch` row (`arch_row`), its touched mask
    (`touched_mask`), a pass's graph key (`pass_key`), the pass's loss and
    metrics (`subnet_pass`: `parts` values, this rank's under a mesh), the
    global batch's metrics from the ranks' summed parts (`global_rows`),
    the teacher's output (`teacher_forward`) and the result's names
    (`metric_names`: (window mean, per step) pairs). The trainer's
    optimizer becomes a `GatedOpt` holding the same state."""

    metric_names = ()

    def __init__(self, trainer, n_subnets, arch_len, parts=None):
        net = trainer.net
        self.device = net.device
        self.group = trainer._group
        if self.device.type == "cuda" and not capturable(self.group):
            raise ValueError(
                "a window step on a CUDA net captures its collectives in CUDA graphs, which "
                "NCCL's allow and this mesh's backend %r does not (its collectives pass "
                "through the host): run the mesh over NCCL" % dist.get_backend(self.group))
        self.world = world_size(self.group)
        if not isinstance(trainer.opt, GatedOpt):
            trainer.opt = GatedOpt(trainer.opt)
        self.trainer = trainer
        self.k = n_subnets
        self.opt = trainer.opt
        self.names = {id(p): n for n, p in net.named_parameters()}
        self.cache = GraphCache(self.device)
        # the pass graphs' subnet (the subclass's view of it)
        self.arch = torch.zeros(arch_len, dtype=torch.int32, device=self.device)
        self.metrics = torch.zeros(parts or len(self.metric_names), device=self.device)
        self.inputs = {}       # (name, shape, dtype) -> static batch tensor
        self.teacher_out = {}  # teacher key -> static teacher output

    def _touched_row(self, mask):
        return [bool(mask[self.names[id(p)]]) for p in self.opt.params]

    def _static_batch(self, batch):
        """The static input buffers for this batch's shapes, loaded with it;
        returns them and their shapes' key."""
        out = {}
        for name, t in batch.items():
            key = (name, tuple(t.shape), t.dtype)
            buf = self.inputs.get(key)
            if buf is None:
                buf = self.inputs[key] = torch.empty_like(t, memory_format=torch.contiguous_format)
            buf.copy_(t)
            out[name] = buf
        return out, tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in out.items()))

    def __call__(self, batches, archs, lrs, touched=None):
        """Run len(batches) optimizer steps. `batches`: one dict of tensors
        on the net's device a step; `archs`: one sequence of `n_subnets`
        subnets a step; `lrs`: one lr a step; `touched`: None (each step's
        mask from its subnets, `touched_mask`: torch's skip of a None grad),
        or one {parameter name: bool} a step. Updates the parameters, the
        optimizer's state and the running statistics in place. Returns the
        window's mean of each metric and each step's mean over its subnets,
        under `metric_names`, as device tensors. Under a mesh each batch is
        this rank's rows and the metrics are the global batch's."""
        n, k, dev = len(batches), self.k, self.device
        if not (len(archs) == len(lrs) == n) or any(len(c) != k for c in archs):
            raise ValueError("a window takes one batch, %d subnets and one lr a step; got %d "
                             "batches, %s subnets, %d lrs" % (k, n, [len(c) for c in archs],
                                                             len(lrs)))
        if touched is None:
            touched = [self.touched_mask(list(c)) for c in archs]
        arch = _pinned(np.asarray([self.arch_row(c) for step in archs for c in step],
                                  np.int32), dev)
        lr = _pinned(np.asarray(lrs, np.float32), dev)
        flags = _pinned(np.asarray([self._touched_row(m) for m in touched], np.bool_), dev)
        metrics = torch.empty(n * k, self.metrics.numel(), device=dev)
        cache, opt = self.cache, self.opt
        main = torch.cuda.current_stream(dev) if cache.cuda else None
        if cache.cuda:
            cache.stream.wait_stream(main)
        with torch.cuda.stream(cache.stream) if cache.cuda else contextlib.nullcontext():
            opt.attach_grads()
            opt.grad.zero_()
            for i in range(n):
                sb, shapes = self._static_batch(batches[i])
                opt.lr.copy_(lr[i])
                opt.touched.copy_(flags[i])
                t_out = None
                if self.kd:
                    tkey = ("teacher", shapes)
                    cache.run(tkey, lambda: self._teacher(tkey, sb))
                    t_out = self.teacher_out[tkey]
                for j, a in enumerate(archs[i]):
                    self.arch.copy_(arch[i * k + j])
                    cache.run(self.pass_key(a, shapes, t_out is not None),
                              lambda: self._pass(sb, a, t_out))
                    metrics[i * k + j].copy_(self.metrics)
                cache.run(("update",), self._update)
            if self.group is not None:
                metrics = self.global_rows(all_reduce_sum(metrics, self.group))
        if cache.cuda:
            main.wait_stream(cache.stream)
        steps = metrics.view(n, k, -1).mean(1)
        out = {}
        for c, (mean, per_step) in enumerate(self.metric_names):
            out[mean], out[per_step] = steps[:, c].mean(), steps[:, c]
        return out

    def _update(self):
        """The step's update; under a mesh the gradients are first summed
        over the ranks and divided by the world size (`average_gradients`),
        so the clip and the step see the global batch's mean gradient."""
        if self.group is not None:
            all_reduce_sum(self.opt.grad, self.group).div_(self.world)
        self.opt.update(self.clip_grad_norm)

    def global_rows(self, summed):
        """The passes' metrics, the global batch's, from their parts summed
        over the ranks (rows of `parts`): each the ranks' mean."""
        return summed / self.world

    def _teacher(self, tkey, sb):
        out = self.teacher_forward(sb)
        buf = self.teacher_out.get(tkey)
        if buf is None:  # the eager first run allocates it, outside the pool
            buf = self.teacher_out[tkey] = torch.empty_like(out)
        buf.copy_(out)

    def _pass(self, sb, a, t_out):
        loss, *rest = self.subnet_pass(sb, a, t_out)
        loss.backward()
        self.metrics.copy_(torch.stack([loss.detach()] + [r.float() for r in rest]))


class SRWindowStep(WindowStep):
    """The callable `SRTrainer.make_scan_train_step` returns: `arch` holds
    the subnet's (ks_idx, mid), one entry a block of every trunk; a pass's
    key holds its depths and pixel_d, the host branches of the masked
    forward. Returns {"loss", "psnr"}: the window's means, and "losses",
    "psnrs": each step's mean over its subnets. Under a mesh a pass keeps
    (loss, sum of squared Y errors, their count), and PSNR-Y is formed from
    the ranks' totals (`SRTrainer._global_metrics`)."""

    metric_names = (("loss", "losses"), ("psnr", "psnrs"))

    def __init__(self, trainer, n_subnets):
        net = trainer.net
        super().__init__(trainer, n_subnets, 2 * net.space.blocks_per_trunk * net.n_trunks,
                         parts=2 if trainer._group is None else 3)
        self.ks_list = list(net.space.ks_list)
        self.kd = trainer.kd_ratio > 0
        self.clip_grad_norm = trainer.clip_grad_norm

    def arch_row(self, cfg):
        sp = self.trainer.net.space
        return [self.ks_list.index(k) for k in cfg.ks] + [sp.mid_channels(e) for e in cfg.e]

    def touched_mask(self, cfgs):
        return sr_touched_mask(self.trainer.net, cfgs, self.trainer.mode)

    def pass_key(self, cfg, shapes, kd):
        tr = self.trainer
        return ("pass", tr.mode, tuple(cfg.d), cfg.pixel_d, str(tr.compute_dtype), shapes,
                tr.bn_frozen, kd, tr.net.dw_lever, tr.net.expand_lever)

    def subnet_pass(self, sb, cfg, t_out):
        rows = self.arch.view(2, -1)
        loss, m = self.trainer._subnet_loss(sb, MaskedArch(rows[0], rows[1], tuple(cfg.d),
                                                           cfg.pixel_d), t_out)
        if self.group is None:
            return loss, m
        sq, count = m
        return loss, sq, torch.full_like(sq, count)

    def global_rows(self, summed):
        return torch.stack([summed[:, 0] / self.world,
                            psnr_from_mse(summed[:, 1] / summed[:, 2])], 1)

    def teacher_forward(self, sb):
        return self.trainer._teacher_out(sb)


class ClsWindowStep(WindowStep):
    """The callable `ClsTrainer.make_scan_train_step` returns: `arch` holds
    the subnet's `arch_vector`; a pass's key is the batch's shapes with the
    step's options, the same for every subnet (its depths are device
    gates). Returns {"loss", "top1", "top5"}: the window's means, and
    "losses", "top1s", "top5s": each step's mean over its subnets."""

    metric_names = (("loss", "losses"), ("top1", "top1s"), ("top5", "top5s"))

    def __init__(self, trainer, n_subnets):
        net = trainer.net
        super().__init__(trainer, n_subnets, net.arch_len)
        self.arch_dev = net.device_arch(self.arch)
        self.kd = trainer.kd_ratio > 0 and trainer.teacher is not None
        self.clip_grad_norm = None
        self.cache.register_generator(trainer.dropout_generator)

    def arch_row(self, a):
        return self.trainer.net.arch_vector(a)

    def touched_mask(self, archs):
        return cls_touched_mask(self.trainer.net, archs)

    def pass_key(self, a, shapes, kd):
        tr = self.trainer
        return ("pass", "cls", shapes, str(tr.compute_dtype), tr.bn_frozen, kd,
                tr.net.dw_lever)

    def subnet_pass(self, sb, a, t_out):
        loss, acc = self.trainer._subnet_loss(sb, self.arch_dev, t_out, masked=True)
        return loss, acc[0], acc[1]

    def teacher_forward(self, sb):
        return self.trainer._soft_labels(sb["image"])
