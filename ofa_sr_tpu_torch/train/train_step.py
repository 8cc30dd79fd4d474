"""The multi-subnet SR training step (counterpart of
ofa_sr_tpu/train/train_step.py `SRTrainer`, `mode="sr"`).

Per optimizer step, as the reference trainer does:
- each of the K sampled subnets computes its loss on the LR input its
  pixel_d selects (`batch["x%d" % 2**pixel_d]`) and calls `backward`, so the
  gradients accumulate; then one optimizer step;
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

PyTorch runs eagerly, so the JAX step's jit, donation and `lax.switch` over
pixel_d have no counterpart; a step is plain Python over the subnets.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.elastic import spatial_valid_mask
from ..utils.metrics import psnr_y_device
from .optim import build_optimizer


class SRTrainer:
    """Train / eval steps for an OFAMobileNetS4 supernet.

    teacher: optional (teacher net, its SubnetConfig, its pixel_d) for KD;
    it runs in eval mode under no_grad. use_kernels (default: on for a CUDA
    net) takes train-mode BN through the BN-statistics kernels.
    compute_dtype: None (float32) or the mixed-precision type, torch.bfloat16.
    """

    def __init__(self, net, *, opt_type="adam", weight_decay=3e-5, momentum=0.9,
                 nesterov=True, clip_grad_norm=None, kd_ratio=0.0,
                 bn_frozen=False, teacher=None, use_kernels: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.net = net
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

    def _forward(self, batch, cfg, *, bn_training):
        pd = cfg.pixel_d
        return self.net(batch["x%d" % 2 ** pd], cfg, pd, bn_training=bn_training,
                        use_kernels=self.use_kernels, compute_dtype=self.compute_dtype)

    def _subnet_loss(self, batch, cfg, teacher_out):
        out = self._forward(batch, cfg, bn_training=not self.bn_frozen).float()
        hr = batch["image"].float()
        mse = torch.mean(torch.square(out - hr))
        if teacher_out is not None:
            kd = torch.mean(torch.square(out - teacher_out))
            loss = (self.kd_ratio * kd + mse) * (2.0 / (self.kd_ratio + 1.0))
        else:
            loss = mse
        return loss, psnr_y_device(out.detach(), hr)

    def _teacher_out(self, batch):
        if not (self.kd_ratio > 0):
            return None
        t_net, t_cfg, t_pd = self.teacher
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
        if self.clip_grad_norm:
            torch.nn.utils.clip_grad_norm_(
                [p for g in self.opt.param_groups for p in g["params"]],
                self.clip_grad_norm)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return {"loss": torch.stack(losses).mean(), "psnr": torch.stack(psnrs).mean()}

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
        LR frame; loss and PSNR-Y average over the valid HR region only.
        Like the JAX step, it runs the float32 weights whatever
        `compute_dtype` is (that step calls `net.apply` on the master
        params), so PSNR-Y is formed in float32."""
        pd = cfg.pixel_d
        vh, vw = (int(v) for v in batch["valid_hw"])
        with torch.no_grad():
            out = self.net(batch["x%d" % 2 ** pd], cfg, pd, bn_training=False,
                           use_kernels=self.use_kernels, valid_hw=(vh, vw))
            hr = batch["image"]
            mask = spatial_valid_mask(vh * 2 ** pd, vw * 2 ** pd, hr.shape[1], hr.shape[2],
                                      hr.dtype, hr.device)
            loss = (torch.square(out - hr) * mask).sum() / (mask.sum() * hr.shape[0]
                                                           * hr.shape[-1])
            return {"loss": loss, "psnr": psnr_y_device(out, hr, valid_mask=mask),
                    "output": out}
