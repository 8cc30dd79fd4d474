"""The classification training step (counterpart of
ofa_sr_tpu/train/cls_trainer.py `ClsTrainer`).

Per optimizer step, as the reference's multi-subnet loop does:
- each of the K sampled subnets runs its train-mode forward and calls
  `backward`, so the gradients of the K subnets add up; then one optimizer
  step (SGD with Nesterov momentum, or Adam, over the `bn#bias` groups of
  `train/optim.py`);
- the loss is cross-entropy with label smoothing, or with KD against a
  teacher `kd_ratio * kd + ce`, where kd is the soft-target cross-entropy
  ("ce") or the mean squared difference ("mse") between the logits and the
  teacher's softmax, the teacher run in eval mode without gradients;
- BN runs in train mode, its running statistics threading through the
  subnets in order, unless `bn_frozen`;
- the metrics (loss, top-1, top-5, each the mean over the subnets) stay
  0-d tensors on the device;
- with `compute_dtype` (bf16) the student's forward runs the JAX package's
  mixed precision (`ElasticClassifierNet.forward`), the loss on float32
  logits; the teacher and the eval step run float32.

Dropout draws from one `torch.Generator` on the net's device, seeded with
`dropout_seed` (the run manager's `manual_seed + 1`, the seed of JAX's
dropout key). Its masks cannot equal `jax.random.bernoulli`'s, so a run
with dropout matches the JAX package in distribution, not in bits: a
stated difference (ROADMAP queue 3). The tests hold the two at dropout 0.

Under a mesh each rank passes its rows of the global batch: every
train-mode BN takes the global batch's moments, the summed gradients are
averaged over the ranks once a step (`train_step.average_gradients`), and
the metrics are the global batch's means.

`train_step` runs eagerly in the sliced form: blocks past a stage's depth
never run, so their gradients stay None and the optimizer skips them (no
decay, no momentum), which JAX gets through `TorchOpt` and
`cls_touched_mask`. `make_scan_train_step` is JAX's device-side multi-step
program (`cls_trainer.py:154-219`): a window of steps in the masked form
(`ElasticClassifierNet.forward_masked`, every block run, depth a device
gate), as CUDA-graph replays on a CUDA net (`train/graphs.py`), with the
optimizer gated by each step's `cls_touched_mask` (`optim.GatedOpt`); on a
CPU net the same masked steps run eagerly. Under a mesh the window has the
eager step's global-batch semantics (`graphs.WindowStep`), its collectives
captured in the graphs over NCCL. JAX's depthwise levers (`ks_switch`,
`dw_switch`, `dw_opts`, cls_trainer.py:66-74) set the net's one lever and
act in the masked form, as `SRTrainer`'s (train/train_step.py): the
elastic blocks' depthwise through `ops/kernels/dw_masked.py`, its kernel
size and width (a gated-off block's 0) read on the device. `train_step`'s sliced
form runs only the sampled taps and channels already. JAX's `remat` is
not ported: the steps fit the card's memory without rematerialization
(ROADMAP queue 1 item 14).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models.layers import set_depthwise_lever
from ..parallel.mesh import all_reduce_sum
from .graphs import ClsWindowStep
from .optim import build_optimizer
from .train_step import average_gradients


def cross_entropy(logits, labels, label_smoothing=0.0):
    """Mean cross-entropy of `logits` against integer `labels`, with label
    smoothing (the reference's cross_entropy_with_label_smoothing: the
    one-hot target mixed with the uniform one). The one-hot is a scatter,
    which reads no label on the host (a CUDA graph captures it)."""
    n = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    if label_smoothing > 0:
        onehot = torch.zeros_like(logp).scatter_(-1, labels[:, None], 1.0)
        soft = onehot * (1 - label_smoothing) + label_smoothing / n
        return -torch.mean(torch.sum(soft * logp, dim=-1))
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def soft_target_ce(logits, soft_target):
    """Mean over the batch of -sum(soft_target * log_softmax(logits))."""
    return torch.mean(torch.sum(-soft_target * torch.log_softmax(logits, dim=-1), dim=-1))


def topk_accuracy(logits, labels, k):
    """Percent of rows whose label is among the k largest logits."""
    pred = torch.topk(logits, k, dim=-1).indices
    hit = (pred == labels[:, None]).any(dim=-1)
    return hit.float().mean() * 100.0


class ClsTrainer:
    """Train / eval steps for an ElasticClassifierNet.

    teacher: optional (teacher net, its ClsArch) for KD when kd_ratio > 0.
    use_kernels (default: on for a CUDA net) takes train-mode BN through the
    BN kernels. compute_dtype: None (float32) or torch.bfloat16. mesh: a
    `parallel.Mesh` for data-parallel training (the batches `train_step`
    takes are then this rank's rows), or None. ks_switch, dw_switch,
    dw_opts: the masked form's depthwise levers (module docstring)."""

    def __init__(self, net, *, opt_type="sgd", weight_decay=3e-5, momentum=0.9, nesterov=True,
                 label_smoothing=0.1, kd_ratio=0.0, kd_type="ce", teacher=None,
                 bn_frozen=False, compute_dtype: Optional[torch.dtype] = None,
                 use_kernels: Optional[bool] = None, mesh=None, dropout_seed=1,
                 ks_switch=False, dw_switch=False, dw_opts=None):
        if kd_type not in ("ce", "mse"):
            raise ValueError("kd_type must be 'ce' or 'mse', got %r" % (kd_type,))
        self.net = net
        self.label_smoothing = label_smoothing
        self.kd_ratio = kd_ratio
        self.kd_type = kd_type
        self.teacher = teacher
        self.bn_frozen = bn_frozen
        self.compute_dtype = compute_dtype
        self.use_kernels = (net.device.type == "cuda" if use_kernels is None
                            else use_kernels)
        self.opt = build_optimizer(net, opt_type, weight_decay, momentum, nesterov)
        self.mesh = mesh
        self._group = None if mesh is None else mesh.group
        self.dropout_generator = torch.Generator(device=net.device).manual_seed(dropout_seed)
        set_depthwise_lever(net, ks_switch, dw_switch, dw_opts)

    def _soft_labels(self, x):
        if not (self.kd_ratio > 0 and self.teacher is not None):
            return None
        t_net, t_arch = self.teacher
        with torch.no_grad():
            return torch.softmax(t_net(x, t_arch), dim=-1)

    def _subnet_loss(self, batch, arch, soft, masked=False):
        """(loss, [top-1, top-5]) of one subnet: `arch` a ClsArch (the sliced
        forward) or, `masked`, the net's device arch (`forward_masked`)."""
        labels = batch["label"]
        kw = dict(training=True, bn_training=not self.bn_frozen, use_kernels=self.use_kernels,
                  dropout_generator=self.dropout_generator, compute_dtype=self.compute_dtype,
                  bn_group=None if self.bn_frozen else self._group)
        if masked:
            logits = self.net.forward_masked(batch["image"], arch, **kw)
        else:
            logits = self.net(batch["image"], arch, **kw)
        ce = cross_entropy(logits, labels, self.label_smoothing)
        if soft is not None:
            kd = (soft_target_ce(logits, soft) if self.kd_type == "ce"
                  else torch.mean(torch.square(logits - soft)))
            loss = self.kd_ratio * kd + ce
        else:
            loss = ce
        logits = logits.detach()
        return loss, torch.stack([topk_accuracy(logits, labels, 1),
                                  topk_accuracy(logits, labels, min(5, logits.shape[-1]))])

    def train_step(self, batch, archs: Sequence, lr):
        """One optimizer step over the subnets `archs` on {"image": NHWC
        float32, "label": int64}; returns {"loss", "top1", "top5"}, each the
        mean over the subnets (over the global batch under a mesh)."""
        soft = self._soft_labels(batch["image"])
        self.opt.zero_grad(set_to_none=True)
        rows = []
        for arch in archs:
            loss, acc = self._subnet_loss(batch, arch, soft)
            loss.backward()
            rows.append(torch.cat([loss.detach()[None], acc]))
        if self._group is not None:
            average_gradients(self.opt, self.mesh)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        m = torch.stack(rows).mean(dim=0)
        if self._group is not None:
            m = all_reduce_sum(m, self._group) / self.mesh.world
        return {"loss": m[0], "top1": m[1], "top5": m[2]}

    def make_scan_train_step(self, n_subnets: int = 1, teacher=None):
        """The window step (JAX `make_scan_train_step`): returns a callable
        `step(batches, archs, lrs, touched=None)` that runs one optimizer step
        a batch, `n_subnets` ClsArchs each (`graphs.WindowStep.__call__`),
        with `train_step`'s semantics (label smoothing, KD "ce" and "mse",
        `bn_frozen`, `compute_dtype`, dropout from the trainer's generator,
        torch's skip of untouched parameters) in the masked form, and
        returns {"loss", "top1", "top5"}, the window's means, and "losses",
        "top1s", "top5s", each step's mean over its subnets, as device
        tensors. `teacher` (net, its ClsArch) replaces the trainer's own.
        The trainer's optimizer becomes a `GatedOpt` holding the same state
        (its `state_dict` keeps torch's layout); `train_step` still runs
        with it.

        Under a mesh each rank passes its rows of each batch (the same
        archs and lrs on every rank); the metrics that come back are the
        global batch's, as `train_step`'s, and every rank ends with the
        same parameters. On a CUDA net the mesh's backend must be NCCL,
        whose collectives the graphs capture (`graphs.WindowStep`)."""
        if teacher is not None:
            self.teacher = teacher
        return ClsWindowStep(self, n_subnets)

    def eval_step(self, batch, arch):
        """Cross-entropy (no smoothing), top-1 and top-5 of subnet `arch`
        with BN in eval mode, float32."""
        with torch.no_grad():
            logits = self.net(batch["image"], arch, use_kernels=self.use_kernels)
            labels = batch["label"]
            return {"loss": cross_entropy(logits, labels),
                    "top1": topk_accuracy(logits, labels, 1),
                    "top5": topk_accuracy(logits, labels, min(5, logits.shape[-1]))}
