"""Multi-step training as CUDA-graph replays: the port's form of the JAX
package's `jit` + `lax.scan` (`SRTrainer.make_scan_train_step`,
ofa_sr_tpu/train/train_step.py:258-327), which has no module of its own to
name there.

A window of N optimizer steps runs each step as
`[teacher] + K x [subnet pass] + [update]`:
- a subnet pass is the masked forward of one subnet (`MaskedArch`: its
  kernel-size indices and middle widths read from a static device buffer),
  its loss and PSNR-Y, and its backward, whose gradients accumulate in
  place into the optimizer's static flat gradient buffer (each parameter's
  `.grad` a view of it);
- the teacher is the KD teacher's eval forward into a static output;
- the update is `GatedOpt.update`, gated by the step's touched flags and
  lr, read from static device buffers, zeroing the gradients after.
Between replays the host only copies device to device: the next batch into
the static inputs, the next subnet's (ks_idx, mid) and the next step's
(touched, lr) from the window's buffers, uploaded once a window from pinned
memory, and each pass's (loss, PSNR-Y) out into the window's metrics.

`GraphCache` keeps one graph per key: a pass by (mode, depths, pixel_d,
compute_dtype, batch shapes, frozen BN, KD), the teacher by its input's
shape, and the one update. The first time a key comes up, its part of the
step runs eagerly on the cache's stream (the real step, and the warm-up
that capture needs), and is then captured without executing, so no step
updates the parameters or running statistics twice. All graphs share one
memory pool: nothing a graph allocates outlives its replay (its outputs go
into buffers allocated outside the pool, held for the run's life), so the
graphs can be replayed in any order. On a CPU net the same code runs
eagerly, part by part: the CPU tests' path.

A wrapper's launch counter counts the eager first run and the capture of
each graph, not its replays.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..models.arch import MaskedArch
from .touched import sr_touched_mask


class GraphCache:
    """Captured CUDA graphs by key, all in one memory pool, on one side
    stream (`stream`), with counts of captures and replays and the seconds
    spent capturing. On a CPU device `run` calls its function."""

    def __init__(self, device):
        self.device = device
        self.graphs = {}
        self.captures = self.replays = 0
        self.capture_s = 0.0
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()

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


class ScanTrainStep:
    """The callable `SRTrainer.make_scan_train_step` returns: a window of
    optimizer steps through the graph cache (see the module docstring)."""

    def __init__(self, trainer, n_subnets):
        self.trainer = trainer
        self.k = n_subnets
        net = trainer.net
        self.device = net.device
        self.opt = trainer.opt
        self.names = {id(p): n for n, p in net.named_parameters()}
        self.cache = GraphCache(self.device)
        self.ks_list = list(net.space.ks_list)
        # the pass graphs' (ks_idx, mid) rows, one entry a block of every trunk
        self.arch = torch.zeros(2, net.space.blocks_per_trunk * net.n_trunks,
                                dtype=torch.int32, device=self.device)
        self.metrics = torch.zeros(2, device=self.device)
        self.inputs = {}       # (name, shape, dtype) -> static batch tensor
        self.teacher_out = {}  # teacher key -> static teacher output

    def _arch_rows(self, cfg):
        sp = self.trainer.net.space
        return [[self.ks_list.index(k) for k in cfg.ks], [sp.mid_channels(e) for e in cfg.e]]

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

    def __call__(self, batches, cfgs, lrs, touched=None):
        """Run len(batches) optimizer steps. `batches`: one dict of tensors
        on the net's device a step ("image", and "x2" / "x4" as the step's
        inputs need); `cfgs`: one sequence of `n_subnets` SubnetConfigs a
        step; `lrs`: one lr a step; `touched`: None (each step's mask from
        its subnets, `sr_touched_mask`: torch's skip of a None grad), or one
        {parameter name: bool} a step. Updates the parameters, the
        optimizer's state and the running statistics in place. Returns
        {"loss", "psnr"}: the window's means, and "losses", "psnrs": each
        step's mean over its subnets, as device tensors."""
        tr, n, k, dev = self.trainer, len(batches), self.k, self.device
        if not (len(cfgs) == len(lrs) == n) or any(len(c) != k for c in cfgs):
            raise ValueError("a window takes one batch, %d subnets and one lr a step; got %d "
                             "batches, %s subnets, %d lrs" % (k, n, [len(c) for c in cfgs],
                                                             len(lrs)))
        if touched is None:
            touched = [sr_touched_mask(tr.net, list(c), tr.mode) for c in cfgs]
        arch = _pinned(np.asarray([self._arch_rows(c) for step in cfgs for c in step],
                                  np.int32), dev)
        lr = _pinned(np.asarray(lrs, np.float32), dev)
        flags = _pinned(np.asarray([self._touched_row(m) for m in touched], np.bool_), dev)
        metrics = torch.empty(n * k, 2, device=dev)
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
                if tr.kd_ratio > 0:
                    tkey = ("teacher", shapes)
                    cache.run(tkey, lambda: self._teacher(tkey, sb))
                    t_out = self.teacher_out[tkey]
                for j, cfg in enumerate(cfgs[i]):
                    self.arch.copy_(arch[i * k + j])
                    key = ("pass", tr.mode, tuple(cfg.d), cfg.pixel_d, str(tr.compute_dtype),
                           shapes, tr.bn_frozen, t_out is not None)
                    march = MaskedArch(self.arch[0], self.arch[1], tuple(cfg.d), cfg.pixel_d)
                    cache.run(key, lambda: self._pass(sb, march, t_out))
                    metrics[i * k + j].copy_(self.metrics)
                cache.run(("update",), lambda: opt.update(tr.clip_grad_norm))
        if cache.cuda:
            main.wait_stream(cache.stream)
        steps = metrics.view(n, k, 2).mean(1)
        return {"loss": steps[:, 0].mean(), "psnr": steps[:, 1].mean(),
                "losses": steps[:, 0], "psnrs": steps[:, 1]}

    def _teacher(self, tkey, sb):
        out = self.trainer._teacher_out(sb)
        buf = self.teacher_out.get(tkey)
        if buf is None:  # the eager first run allocates it, outside the pool
            buf = self.teacher_out[tkey] = torch.empty_like(out)
        buf.copy_(out)

    def _pass(self, sb, march, t_out):
        loss, psnr = self.trainer._subnet_loss(sb, march, t_out)
        loss.backward()
        self.metrics.copy_(torch.stack([loss.detach(), psnr.float()]))
