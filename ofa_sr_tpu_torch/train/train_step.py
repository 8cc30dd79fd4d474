"""The multi-subnet SR training step (counterpart of
ofa_sr_tpu/train/train_step.py `SRTrainer`).

Per optimizer step, as the reference trainer does:
- each of the K sampled subnets computes its loss on the LR input its
  pixel_d selects (`batch["x%d" % 2**pixel_d]`; an X4 net runs its decoder
  on it), or with `mode="autoencoder"` (an X4 net) on the HR frame
  `batch["image"]` through the encoder and the decoder, and calls
  `backward`, so the gradients accumulate; then one optimizer step;
- the loss is MSE against `batch["image"]`, or with KD against a teacher's
  eval forward `(r * kd + mse) * 2 / (r + 1)`;
- BN runs in train mode and its running statistics thread through the
  subnets in order, unless `bn_frozen` (BN in eval mode throughout);
- PSNR-Y is computed on the device; the step returns the mean loss and PSNR
  over its subnets as 0-d tensors, so it never waits on the device;
- with `compute_dtype` (bf16) the student's forward runs in mixed precision
  under the JAX package's rule (`cast_params_for_compute`): the LR input
  and every conv bank are cast at use, while the BN parameters,
  kernel-transform matrices, master parameters, optimizer state, loss and
  PSNR stay float32 (the loss takes `out.float()` against the float32 HR
  frame; the KD teacher's forward stays float32). The casts are explicit,
  not `torch.autocast`, whose per-op rules would round elsewhere.

Under a mesh (`mesh`, data parallelism: each rank passes its rows of the
global batch, `parallel.shard_batch`) the step has the JAX package's
global-batch semantics, where XLA inserts the collectives under a sharded
jit:
- every train-mode BN takes the moments of all the ranks' rows (the BN
  wrappers' `group`: an all-reduce of the column totals each way);
- the K subnets' gradients accumulate locally, then one all-reduce of all
  present gradients, flattened into one buffer and divided by the world
  size, before the one optimizer step (the JAX package's note:
  backward_passes_per_step -> the all-reduce fires once a step). The net
  is not wrapped in DistributedDataParallel: every step slices other
  subnets, and blocks past a stage's depth keep a None gradient; every rank
  samples the same subnets, so the None pattern is the same on every rank;
- the metrics are the global batch's: the losses averaged over the ranks,
  and PSNR-Y formed from the all-reduced sums of squared Y errors (not from
  the ranks' PSNRs);
- the KD teacher's eval forward and the eval steps take no collective.
Every rank then holds the same gradients, so the same update keeps the
parameters identical bit for bit.

`train_step` runs eagerly: a step is plain Python over the subnets, each in
the sliced form. `make_scan_train_step` is the JAX package's device-side
multi-step training: a window of steps in the masked form (`MaskedArch`),
as CUDA-graph replays on a CUDA net (`train/graphs.py`), with the
optimizer gated by each step's touched mask (`optim.GatedOpt`); on a CPU
net the same masked steps run eagerly. Under a mesh the window keeps the
rules above, its collectives captured in the graphs (NCCL) on the card.

The JAX package's depthwise levers (`ks_switch`, `dw_switch`, `dw_opts`;
its `SRTrainer` kwargs, ofa_sr_tpu/train/train_step.py:98-119) set the
net's depthwise lever (`models.layers.set_depthwise_lever`), which acts in
the masked form: the window step's depthwise runs only the sampled kernel
size's taps over the channels below the sampled width, through the
hand-written kernel `ops/kernels/dw_masked.py` on the card, reading both
from the device, so no new graph key a subnet and the same values. Off by
default, as in JAX. JAX's `expand_switch` (a branch per middle width
around each block) sets the net's expand lever
(`models.layers.set_expand_lever`): the window step's 1x1 expand and
project convs run bounded by the sampled width, through the hand-written
GEMM `ops/kernels/pw_masked.py` on the card, which reads the width from the
device, so again no new graph key and the same values; it combines with
the depthwise levers. Off by default, as in JAX, whose `ClsTrainer` has no
such lever. `train_step`'s sliced form runs only the sampled taps and
channels already: the levers change nothing there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models.layers import set_depthwise_lever, set_expand_lever
from ..ops.elastic import spatial_valid_mask
from ..parallel.mesh import all_reduce_sum
from ..utils.metrics import psnr_from_mse, psnr_y_device, y_squared_error_sum
from .graphs import SRWindowStep
from .optim import build_optimizer


def average_gradients(opt, mesh):
    """Every present gradient of `opt`'s parameters, flattened into one
    buffer, summed over the mesh's ranks and divided by the world size: the
    global batch's mean gradient, the same bits on every rank."""
    params = [p for g in opt.param_groups for p in g["params"] if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_sum(flat, mesh.group).div_(mesh.world)
    # each gradient becomes its view of the reduced buffer (zero_grad drops
    # them before the next step)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


class SRTrainer:
    """Train / eval steps for an OFAMobileNetS4 or OFAMobileNetX4 supernet.

    mode: "sr" (an LR input; an X4 net runs its decoder alone) or
    "autoencoder" (an X4 net on the HR frame). teacher: optional (teacher
    net, its SubnetConfig, its pixel_d) for KD; it runs in eval mode under
    no_grad. use_kernels (default: on for a CUDA net) takes train-mode BN
    through the BN-statistics kernels. compute_dtype: None (float32) or the
    mixed-precision type, torch.bfloat16. mesh: a `parallel.Mesh` for
    data-parallel training (the batches `train_step` takes are then this
    rank's rows), or None. ks_switch, dw_switch (False, True, "dw" or
    "project"), dw_opts: JAX's depthwise levers of the masked form, any of
    which sets the net's depthwise lever; expand_switch: JAX's expand
    lever, the masked form's 1x1 convs bounded by the sampled width
    (module docstring).
    """

    def __init__(self, net, *, opt_type="adam", weight_decay=3e-5, momentum=0.9,
                 nesterov=True, clip_grad_norm=None, kd_ratio=0.0,
                 bn_frozen=False, teacher=None, use_kernels: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None, mode: str = "sr", mesh=None,
                 ks_switch=False, dw_switch=False, dw_opts=None, expand_switch=False):
        if mode not in ("sr", "autoencoder"):
            raise ValueError("mode must be 'sr' or 'autoencoder', got %r" % (mode,))
        if mode == "autoencoder" and net.n_trunks != 2:
            raise ValueError("mode='autoencoder' needs an OFAMobileNetX4 (an encoder)")
        self.net = net
        self.mode = mode
        self.kd_ratio = kd_ratio
        self.bn_frozen = bn_frozen
        self.clip_grad_norm = clip_grad_norm
        self.teacher = teacher
        self.compute_dtype = compute_dtype
        if kd_ratio > 0 and teacher is None:
            raise ValueError("kd_ratio > 0 needs a teacher")
        self.use_kernels = (net.device.type == "cuda" if use_kernels is None
                            else use_kernels)
        self.opt = build_optimizer(net, opt_type, weight_decay, momentum, nesterov)
        self.mesh = mesh
        self._group = None if mesh is None else mesh.group
        set_depthwise_lever(net, ks_switch, dw_switch, dw_opts)
        set_expand_lever(net, expand_switch)

    def _input(self, batch, pixel_d):
        return batch["image"] if self.mode == "autoencoder" else batch["x%d" % 2 ** pixel_d]

    def _forward(self, batch, cfg, *, bn_training):
        pd = cfg.pixel_d
        return self.net(self._input(batch, pd), cfg, pd, bn_training=bn_training,
                        use_kernels=self.use_kernels, compute_dtype=self.compute_dtype,
                        mode=self.mode, bn_group=self._group if bn_training else None)

    def _subnet_loss(self, batch, cfg, teacher_out):
        """(loss, PSNR-Y) of one subnet on the batch; under a mesh the
        second is (sum of squared Y errors, their count), which add over the
        ranks."""
        out = self._forward(batch, cfg, bn_training=not self.bn_frozen).float()
        hr = batch["image"].float()
        mse = torch.mean(torch.square(out - hr))
        if teacher_out is not None:
            kd = torch.mean(torch.square(out - teacher_out))
            loss = (self.kd_ratio * kd + mse) * (2.0 / (self.kd_ratio + 1.0))
        else:
            loss = mse
        if self._group is not None:
            return loss, y_squared_error_sum(out.detach(), hr)
        return loss, psnr_y_device(out.detach(), hr)

    def _teacher_out(self, batch):
        if not (self.kd_ratio > 0):
            return None
        t_net, t_cfg, t_pd = self.teacher
        # the teacher runs its default mode on the LR input whatever the
        # student's mode (an X4 teacher: its decoder alone), as the JAX
        # package's step calls `teacher_net.apply`
        with torch.no_grad():
            return t_net(batch["x%d" % 2 ** t_pd], t_cfg, t_pd, bn_training=False).float()

    def train_step(self, batch, cfgs: Sequence, lr):
        """One optimizer step over the subnets `cfgs`; returns {"loss",
        "psnr"}, each the mean over the subnets."""
        teacher_out = self._teacher_out(batch)
        self.opt.zero_grad(set_to_none=True)
        losses, psnrs = [], []
        for cfg in cfgs:
            loss, psnr = self._subnet_loss(batch, cfg, teacher_out)
            loss.backward()
            losses.append(loss.detach())
            psnrs.append(psnr)
        if self._group is not None:
            average_gradients(self.opt, self.mesh)
        if self.clip_grad_norm:
            torch.nn.utils.clip_grad_norm_(
                [p for g in self.opt.param_groups for p in g["params"]],
                self.clip_grad_norm)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        if self._group is not None:
            return self._global_metrics(losses, psnrs)
        return {"loss": torch.stack(losses).mean(), "psnr": torch.stack(psnrs).mean()}

    def make_scan_train_step(self, n_subnets: int = 1, teacher=None):
        """The window step (JAX `make_scan_train_step`): returns a callable
        `step(batches, cfgs, lrs, touched=None)` that runs one optimizer step
        a batch, `n_subnets` subnets each (`graphs.WindowStep.__call__`),
        with `train_step`'s semantics (KD, `bn_frozen`, `compute_dtype`,
        `clip_grad_norm`, torch's skip of untouched parameters) in the
        masked form, and returns the window's mean loss and PSNR-Y as 0-d
        device tensors. `teacher` (net, its SubnetConfig, its pixel_d)
        replaces the trainer's own. The trainer's optimizer becomes a
        `GatedOpt` holding the same state (its `state_dict` keeps torch's
        layout); `train_step` still runs with it.

        Under a mesh each rank passes its rows of each batch (the same
        subnets and lrs on every rank); the loss and PSNR-Y that come back
        are the global batch's, as `train_step`'s, and every rank ends with
        the same parameters. On a CUDA net the mesh's backend must be NCCL,
        whose collectives the graphs capture (`graphs.WindowStep`)."""
        if teacher is not None:
            self.teacher = teacher
        if self.kd_ratio > 0 and self.teacher is None:
            raise ValueError("kd_ratio > 0 needs a teacher")
        return SRWindowStep(self, n_subnets)

    def _global_metrics(self, losses, sq_errors):
        """The global batch's mean loss and PSNR-Y over the subnets, from
        each rank's losses (means over equal shares of the batch) and sums
        of squared Y errors, in one all-reduce."""
        k, world = len(losses), self.mesh.world
        totals = all_reduce_sum(torch.stack(losses + [s.float() for s, _ in sq_errors]),
                                self._group)
        mses = torch.stack([totals[k + i] / (n * world) for i, (_, n) in enumerate(sq_errors)])
        return {"loss": (totals[:k] / world).mean(), "psnr": psnr_from_mse(mses).mean()}

    def eval_step(self, batch, cfg):
        """MSE and PSNR-Y of subnet `cfg` with BN in eval mode; "output" in
        the compute type. As in the JAX eval step, PSNR-Y quantizes the
        output and forms its Y in the output's type (bf16 under
        `compute_dtype`); loss and PSNR come out float32."""
        with torch.no_grad():
            out = self._forward(batch, cfg, bn_training=False)
            hr = batch["image"]
            return {"loss": torch.mean(torch.square(out.float() - hr)),
                    "psnr": psnr_y_device(out, hr), "output": out}

    def bucketed_eval_step(self, batch, cfg):
        """Shape-bucketed evaluation (the JAX `make_bucketed_eval_step`): the
        batch holds zero-padded frames and "valid_hw", the (h, w) of the real
        input frame (the LR frame; the HR frame in autoencoder mode, its
        sides multiples of 2^pixel_d); loss and PSNR-Y average over the
        valid HR region only. Like the JAX step, it runs the float32 weights
        whatever `compute_dtype` is (that step calls `net.apply` on the
        master params), so PSNR-Y is formed in float32."""
        pd = cfg.pixel_d
        vh, vw = (int(v) for v in batch["valid_hw"])
        scale = 1 if self.mode == "autoencoder" else 2 ** pd
        with torch.no_grad():
            out = self.net(self._input(batch, pd), cfg, pd, bn_training=False,
                           use_kernels=self.use_kernels, valid_hw=(vh, vw), mode=self.mode)
            hr = batch["image"]
            mask = spatial_valid_mask(vh * scale, vw * scale, hr.shape[1], hr.shape[2],
                                      hr.dtype, hr.device)
            loss = (torch.square(out - hr) * mask).sum() / (mask.sum() * hr.shape[0]
                                                           * hr.shape[-1])
            return {"loss": loss, "psnr": psnr_y_device(out, hr, valid_mask=mask),
                    "output": out}
