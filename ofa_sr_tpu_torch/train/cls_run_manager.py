"""The classification run manager (counterpart of
ofa_sr_tpu/train/cls_run_manager.py `ClsRunManager`, the reference's
RunManager / DistributedRunManager).

`ClsRunManager` owns one run of an ElasticClassifierNet: it samples
subnets on the host under the reference seed contract (`subnet_seed`, in
JAX's draw order), feeds the provider's numpy batches to `ClsTrainer`
(each moved to the device once, from pinned memory on a GPU), validates,
gates the best checkpoint, resumes, and logs to
`<path>/logs/{train,valid}_console.txt`. The net carries its weights
(seeded at construction, or loaded); checkpoints are the port's own
(`train/checkpoint.py`).

The step's metrics stay 0-d device tensors: the epoch sums them on the
device and reads them back only where it logs and when the epoch ends.

With a `mesh` (data parallelism, one process a device, every rank running
the same run over the same provider) the rules are `SRRunManager`'s: the
parameters are broadcast from rank 0 at the start, each training batch is
split over the ranks (`parallel.shard_batch`), train-mode BN takes the
global batch's moments, the gradients are averaged over the ranks once a
step, validation runs whole on every rank, and rank 0 alone writes files.

`RunConfig.steps_per_dispatch` > 1 (JAX `cls_run_manager.py:91-101`,
`:194-267`) runs the epoch in windows of that many steps through
`ClsTrainer.make_scan_train_step` (the masked step as CUDA-graph replays
on a GPU, each step's optimizer gated by `cls_touched_mask`), the tail
shorter than a window through the same step (JAX runs it eagerly), and
records once a window: its metrics are the window's means, and it logs
where a print boundary falls inside the window (JAX's rule). At 1 each
step runs `train_step` eagerly in the sliced form, where torch's
optimizers skip the blocks no subnet ran (a None gradient). Under a mesh
the windows keep the rules above: each batch of a window split over the
ranks, the same archs and lrs on every rank, the global batch's metrics
(NCCL on the card, its collectives captured in the graphs).
`RunConfig.ks_switch`, `dw_switch` and `dw_align` go to `ClsTrainer`, the
masked window step's depthwise levers (JAX cls_run_manager.py:78-79, which
leaves `dw_align` out; it changes no number). JAX's `_apply_dw_live`
narrows compiled branches the kernel does not have (`SRRunManager`'s
note); `remat` is not ported (`ClsTrainer`'s note).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..models.arch import subnet_seed
from ..parallel.mesh import shard_batch, shard_params
from ..utils.common import AverageMeter
from .bn_recalib import bn_recalibrate
from .checkpoint import CHECKPOINT_NAME, load_checkpoint, load_weights_lenient, save_checkpoint
from .cls_trainer import ClsTrainer
from .run_manager import RunConfig, _compute_dtype_of, depthwise_kw
from .schedules import lr_at_step


class ClsRunManager:
    """Owns one training run of an ElasticClassifierNet.

    `teacher` is (teacher net, its ClsArch) for KD when kd_ratio > 0; `mesh`
    a `parallel.Mesh` for a data-parallel run."""

    def __init__(self, path, net, run_config: RunConfig, provider, *, teacher=None,
                 label_smoothing=0.1, mesh=None, use_kernels: Optional[bool] = None):
        self.path = path
        self.net = net
        self.run_config = run_config
        self.provider = provider
        self.mesh = mesh
        # the one process that writes files
        self.writer = mesh is None or mesh.rank == 0
        if self.writer:
            os.makedirs(os.path.join(path, "logs"), exist_ok=True)
            os.makedirs(self.save_path, exist_ok=True)

        self.start_epoch = 0
        self.best_acc = -1e9
        rc = run_config
        use_teacher = teacher is not None and rc.kd_ratio > 0
        self.trainer = ClsTrainer(
            net, opt_type=rc.opt_type, weight_decay=rc.weight_decay, momentum=rc.momentum,
            nesterov=rc.nesterov, label_smoothing=label_smoothing,
            kd_ratio=rc.kd_ratio if use_teacher else 0.0, kd_type=rc.kd_type or "ce",
            teacher=teacher if use_teacher else None, bn_frozen=rc.bn_frozen,
            compute_dtype=_compute_dtype_of(rc), use_kernels=use_kernels, mesh=mesh,
            dropout_seed=rc.manual_seed + 1, **depthwise_kw(rc))
        if mesh is not None:
            shard_params(net, mesh)
        self._scan_step = None

    def _to_device(self, batch, shard=False):
        """The batch's tensors on the net's device, copied without blocking
        the host from pinned memory on a GPU. `shard`: this rank's rows under
        a mesh."""
        if shard and self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        dev = self.net.device
        out = {}
        for k in ("image", "label"):
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            out[k] = (t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda"
                      else t.to(dev))
        return out

    # -- paths / logging ------------------------------------------------------

    @property
    def save_path(self):
        return os.path.join(self.path, "checkpoint")

    def write_log(self, s, prefix="valid", should_print=True):
        """Append to logs/valid_console.txt ("valid", "test") or
        logs/train_console.txt (anything else); rank 0's alone under a
        mesh."""
        if not self.writer:
            return
        fname = "valid_console.txt" if prefix in ("valid", "test") else "train_console.txt"
        with open(os.path.join(self.path, "logs", fname), "a") as f:
            f.write(s + "\n")
        if should_print:
            print(s)

    # -- checkpointing --------------------------------------------------------

    def save_model(self, *, epoch, is_best=False, name=CHECKPOINT_NAME):
        """Write the checkpoint (rank 0 alone under a mesh; the others
        return None)."""
        if not self.writer:
            return None
        return save_checkpoint(
            self.save_path,
            {"epoch": epoch, "best_acc": self.best_acc, "model": self.net.state_dict(),
             "optimizer": self.trainer.opt.state_dict()},
            name=name, is_best=is_best)

    def load_model(self, path=None):
        """Restore the net, the optimizer, start_epoch and best_acc; a
        missing checkpoint leaves the run to start from scratch."""
        try:
            ckpt = load_checkpoint(path or self.save_path)
            self.net.load_state_dict(ckpt["model"])
            self.trainer.opt.load_state_dict(ckpt["optimizer"])
            self.start_epoch = int(ckpt.get("epoch", -1)) + 1
            self.best_acc = float(ckpt.get("best_acc", -1e9))
        except (FileNotFoundError, KeyError) as e:
            self.write_log("fail to load checkpoint: %s" % e, "valid")

    def load_weights(self, path):
        """Warm-start weights only, lenient across elastic spaces (the
        reference's strict=False load)."""
        stats = load_weights_lenient(path, self.net)
        if stats["kept_template"] or stats["dropped"]:
            self.write_log("load_weights(%s): %d net leaves kept fresh init, %d checkpoint "
                           "leaves unused" % (path, stats["kept_template"], stats["dropped"]),
                           "valid")

    # -- train / validate -----------------------------------------------------

    def sample_archs(self, epoch, n_batch, batch_idx, constraints=None):
        """The step's `dynamic_batch_size` subnets: draw k from
        subnet_seed(epoch, n_batch, batch_idx, k)."""
        cons = constraints or {}
        return [self.net.sample_arch(seed=subnet_seed(epoch, n_batch, batch_idx, k), **cons)
                for k in range(self.run_config.dynamic_batch_size)]

    def train_one_epoch(self, epoch, constraints=None):
        """One epoch of steps; returns (mean loss, mean top-1) over every
        step, weighted by batch size (by a window's total under
        steps_per_dispatch > 1, whose metrics are the window's means)."""
        rc = self.run_config
        loader = self.provider.train
        loader.set_epoch(epoch)
        n_batch = len(loader)
        acc = {"sums": None, "n": 0}
        pending = []
        if rc.steps_per_dispatch > 1 and self._scan_step is None:
            self._scan_step = self.trainer.make_scan_train_step(rc.dynamic_batch_size)

        def record(m, n, i, lr, k=1):
            step = torch.stack([m["loss"], m["top1"]]) * n
            acc["sums"] = step if acc["sums"] is None else acc["sums"] + step
            acc["n"] += n
            # `k` steps in this record: log where a print boundary falls
            # inside them (the JAX package's rule)
            if ((i + 1) // rc.print_frequency > (i + 1 - k) // rc.print_frequency
                    or i + 1 == n_batch):
                self.write_log("Train [%d][%d/%d] loss %.4f top1 %.2f lr %.4g"
                               % (epoch + 1, i + 1, n_batch, float(m["loss"]),
                                  float(m["top1"]), lr), "train", should_print=False)

        def flush():
            if pending:
                m = self._scan_step([q[0] for q in pending], [q[1] for q in pending],
                                    [q[2] for q in pending])
                record(m, sum(q[3] for q in pending), pending[-1][4], pending[-1][2],
                       k=len(pending))
                pending.clear()

        for i, batch in enumerate(loader):
            lr = lr_at_step(rc.base_lr, epoch, i, n_batch, rc.n_epochs,
                            warmup_epochs=rc.warmup_epochs, warmup_lr=rc.warmup_lr,
                            lr_schedule_type=rc.lr_schedule_type)
            archs = self.sample_archs(epoch, n_batch, i, constraints)
            n = len(batch["label"])
            if self._scan_step is not None:
                pending.append((self._to_device(batch, shard=True), archs, lr, n, i))
                if len(pending) == rc.steps_per_dispatch:
                    flush()
                continue
            m = self.trainer.train_step(self._to_device(batch, shard=True), archs, lr)
            record(m, n, i, lr)
        flush()
        if acc["sums"] is None:
            return 0.0, 0.0
        loss, top1 = (s / acc["n"] for s in acc["sums"].tolist())
        return loss, top1

    def validate(self, arch=None, loader=None):
        """(loss, top-1, top-5) over the loader (the test split by default)
        for one subnet (the max one by default), BN in eval mode."""
        arch = arch or self.net.max_arch()
        loader = loader if loader is not None else self.provider.test
        losses, top1s, top5s = AverageMeter(), AverageMeter(), AverageMeter()
        for batch in loader:
            out = self.trainer.eval_step(self._to_device(batch), arch)
            n = len(batch["label"])
            loss, top1, top5 = torch.stack([out["loss"], out["top1"], out["top5"]]).tolist()
            losses.update(loss, n)
            top1s.update(top1, n)
            top5s.update(top5, n)
        return losses.avg, top1s.avg, top5s.avg

    def train(self, constraints=None, validate_archs=None):
        """Epoch loop from start_epoch with validation every
        validation_frequency epochs (the mean top-1 over `validate_archs`,
        the max subnet by default), best-accuracy gating, and a checkpoint
        every epoch. Returns the best accuracy."""
        rc = self.run_config
        for epoch in range(self.start_epoch, rc.n_epochs + rc.warmup_epochs):
            t0 = time.time()
            tr_loss, tr_top1 = self.train_one_epoch(epoch, constraints)
            if (epoch + 1) % rc.validation_frequency == 0:
                accs = [self.validate(a)[1] for a in (validate_archs or [None])]
                acc = float(np.mean(accs))
                is_best = acc > self.best_acc
                self.best_acc = max(self.best_acc, acc)
                self.write_log("Epoch %d: train loss %.4f top1 %.2f | valid top1 %.2f "
                               "(best %.2f) (%.1fs)" % (epoch + 1, tr_loss, tr_top1, acc,
                                                        self.best_acc, time.time() - t0),
                               "valid")
                self.save_model(epoch=epoch, is_best=is_best)
            else:
                self.save_model(epoch=epoch)
        return self.best_acc

    def reset_running_statistics(self, arch, n_images=2000, batch_size=100):
        """Recalibrate the running statistics for `arch` over the
        provider's calibration subset (`bn_recalibrate`)."""
        loader = self.provider.build_sub_train_loader(n_images, batch_size)
        bn_recalibrate(self.net, arch, None, loader, use_kernels=self.trainer.use_kernels,
                       mesh=self.mesh)
