"""Run management: the run config and the SR training / validation
orchestrator (counterpart of ofa_sr_tpu/train/run_manager.py): an S4 net,
or an X4 net in `mode="sr"` (its decoder) or `mode="autoencoder"`.

`SRRunManager` owns one run of a supernet: it samples subnets on the host
under the reference seed contract, feeds the provider's numpy batches to
`SRTrainer` (each moved to the device once, from pinned memory on a GPU),
validates, gates the best checkpoint, resumes, and logs to
`<path>/logs/{train,valid}_console.txt`.

The step's metrics stay 0-d device tensors: the epoch sums them on the
device and reads them back only where it logs and when the epoch ends, so
a step adds no host-device synchronisation.

Left out of the JAX package's RunConfig: the XLA-only execution levers
(`steps_per_dispatch`, `remat`, `ks_switch`, `dw_switch`, `dw_align`,
`s2d`; ROADMAP queue 1 item 14).

With a `mesh` (data parallelism, one process a device, every rank running
the same run over the same provider): the parameters are broadcast from
rank 0 at the start, each training batch is split over the ranks
(`parallel.shard_batch`) and the trainer takes the global batch's BN
moments, gradient and metrics; validation runs whole on every rank, as the
JAX package runs it replicated; checkpoints, `latest.txt`, the logs and the
run's info files are written by rank 0 alone, the process-per-device form
of JAX's single writer.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..models.arch import (
    SubnetConfig,
    max_subnet,
    reference_quirk_arch_s4,
    reference_quirk_arch_x4,
    sample_subnet,
    subnet_seed,
    uniform_subnet,
)
from ..parallel.mesh import shard_batch, shard_params
from ..utils.common import AverageMeter
from .bn_recalib import bn_recalibrate
from .checkpoint import (
    CHECKPOINT_NAME,
    load_checkpoint,
    load_weights_lenient,
    save_checkpoint,
    save_weights,
)
from .schedules import lr_at_step
from .train_step import SRTrainer


@dataclasses.dataclass
class RunConfig:
    """All run hyperparameters (defaults: the SR supernet scripts')."""

    n_epochs: int = 25
    base_lr: float = 1e-4
    warmup_epochs: int = 0
    warmup_lr: float = -1
    lr_schedule_type: Optional[str] = "cosine"

    opt_type: str = "adam"
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 3e-5
    # global-norm gradient clipping; None/0 = off (the reference never clips)
    clip_grad_norm: Optional[float] = None

    train_batch_size: int = 16
    test_batch_size: int = 1
    validation_frequency: int = 1
    print_frequency: int = 10
    # epochs between checkpoint saves on non-validation epochs (the final
    # epoch always saves)
    save_frequency: int = 1

    dynamic_batch_size: int = 1
    kd_ratio: float = 0.0
    # the classification trainer's KD loss: "ce" (soft-target cross-entropy)
    # or "mse" against the teacher's softmax; None means "ce"
    kd_type: Optional[str] = None
    # sandwich rule: subnet k=0 of every step is the max corner within the
    # constraints (needs dynamic_batch_size >= 2); draws k >= 1 keep the
    # reference seed contract
    sandwich_rule: bool = False
    # per-corner best gating: snapshot best_<corner>.pth.tar whenever a
    # validated corner reaches a new best PSNR (corner_best.json records
    # where); observation only
    corner_gate: bool = False

    manual_seed: int = 0
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5

    mode: str = "sr"                      # 'sr' | 'autoencoder'
    bn_frozen: bool = False               # SR oracle 'BN always eval'
    bn_recalib_before_eval: bool = False  # OFA-canonical eval does recalib
    image_size: int = 96
    # shape-bucketed eval: LR frames zero-padded up to multiples of this
    eval_bucket: Optional[int] = None
    # train the architectures the reference executes (arch.reference_quirk_*)
    reference_quirks: bool = False
    # 'bf16': mixed precision (conv banks and activations; BN statistics,
    # transform matrices, master params and loss stay float32). None = f32.
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.save_frequency < 1:
            raise ValueError("save_frequency must be >= 1 (got %r)"
                             % (self.save_frequency,))

    @property
    def config(self):
        return dataclasses.asdict(self)


def _compute_dtype_of(run_config):
    if run_config.compute_dtype in (None, "", "f32", "float32"):
        return None
    if run_config.compute_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError("unknown compute_dtype %r" % run_config.compute_dtype)


def _bucket_pad(batch, pixel_d, bucket, mode="sr"):
    """Zero-pad a variable-shape eval batch's LR frame up to the next
    multiple of `bucket` (and its HR frame to match), recording the real LR
    size as "valid_hw"; in autoencoder mode the HR frame alone, with its
    size."""
    hr = np.asarray(batch["image"])
    if mode == "autoencoder":
        h, w = hr.shape[1], hr.shape[2]
        hp = np.zeros((hr.shape[0], -(-h // bucket) * bucket, -(-w // bucket) * bucket,
                       hr.shape[3]), hr.dtype)
        hp[:, :h, :w] = hr
        return {"image": hp, "valid_hw": np.asarray([h, w], np.int32)}
    key = "x%d" % (2 ** pixel_d)
    x = np.asarray(batch[key])
    h, w = x.shape[1], x.shape[2]
    bh = -(-h // bucket) * bucket
    bw = -(-w // bucket) * bucket
    scale = 2 ** pixel_d
    xp = np.zeros((x.shape[0], bh, bw, x.shape[3]), x.dtype)
    xp[:, :h, :w] = x
    hp = np.zeros((hr.shape[0], bh * scale, bw * scale, hr.shape[3]), hr.dtype)
    hp[:, :h * scale, :w * scale] = hr
    return {key: xp, "image": hp, "valid_hw": np.asarray([h, w], np.int32)}


class SRRunManager:
    """Owns one training run of an OFAMobileNetS4 or OFAMobileNetX4 supernet.

    `net` carries its weights (seeded at construction, or loaded); `teacher`
    is (teacher net, its SubnetConfig) for KD when kd_ratio > 0; `mesh` a
    `parallel.Mesh` for a data-parallel run."""

    def __init__(self, path, net, run_config: RunConfig, provider, *,
                 teacher=None, mesh=None, use_kernels: Optional[bool] = None):
        self.path = path
        self.net = net
        self.run_config = run_config
        self.provider = provider
        self.mesh = mesh
        # the one process that writes files
        self.writer = mesh is None or mesh.rank == 0
        if self.writer:
            os.makedirs(self.logs_path, exist_ok=True)
            os.makedirs(self.save_path, exist_ok=True)

        self.start_epoch = 0
        self.best_acc = -1e9  # best mean PSNR ("best_acc" naming kept)

        kd = {}
        if teacher is not None and run_config.kd_ratio > 0:
            t_net, t_cfg = teacher
            kd = dict(kd_ratio=run_config.kd_ratio, teacher=(t_net, t_cfg, t_cfg.pixel_d))
        self.trainer = SRTrainer(
            net, opt_type=run_config.opt_type, weight_decay=run_config.weight_decay,
            momentum=run_config.momentum, nesterov=run_config.nesterov,
            clip_grad_norm=run_config.clip_grad_norm, bn_frozen=run_config.bn_frozen,
            use_kernels=use_kernels, compute_dtype=_compute_dtype_of(run_config),
            mode=run_config.mode, mesh=mesh, **kd)
        if mesh is not None:
            shard_params(net, mesh)
        self._write_net_info()

    def _to_device(self, batch, shard=False):
        """Tensors on the net's device, copied without blocking the host
        from pinned memory on a GPU; "valid_hw" stays host ints. `shard`:
        this rank's rows of the batch under a mesh."""
        if shard and self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        dev = self.net.device
        out = {}
        for k, v in batch.items():
            if k == "valid_hw":
                out[k] = tuple(int(a) for a in v)
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda"
                      else t.to(dev))
        return out

    # -- paths / logging ------------------------------------------------------

    @property
    def save_path(self):
        return os.path.join(self.path, "checkpoint")

    @property
    def logs_path(self):
        return os.path.join(self.path, "logs")

    def write_log(self, log_str, prefix="valid", should_print=True):
        """Append to logs/valid_console.txt ("valid", "test") or
        logs/train_console.txt (anything else); rank 0's alone under a
        mesh."""
        if not self.writer:
            return
        fname = {"valid": "valid_console.txt", "test": "valid_console.txt"}.get(
            prefix, "train_console.txt")
        with open(os.path.join(self.logs_path, fname), "a") as f:
            if prefix in ("valid", "test"):
                f.write("=" * 10 + "\n")
            f.write(log_str + "\n")
        if should_print:
            print(log_str)

    def _write_net_info(self):
        if not self.writer:
            return
        n_params = sum(p.numel() for p in self.net.parameters())
        info = {"name": type(self.net).__name__, "param_count": n_params,
                "space": dataclasses.asdict(self.net.space)}
        with open(os.path.join(self.path, "net_info.txt"), "w") as f:
            f.write(json.dumps(info) + "\n")
        with open(os.path.join(self.path, "run.config"), "w") as f:
            json.dump(self.run_config.config, f, indent=2)

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
            self.write_log("=> loaded checkpoint (epoch %d)" % self.start_epoch, "valid")
        except (FileNotFoundError, KeyError) as e:
            self.write_log("fail to load checkpoint: %s" % e, "valid")

    def load_weights(self, path):
        """Warm-start weights only, lenient across elastic spaces (the
        reference's strict=False load). Returns `load_weights_lenient`'s
        {"kept_template", "dropped"} counts."""
        stats = load_weights_lenient(path, self.net)
        if stats["kept_template"] or stats["dropped"]:
            self.write_log("load_weights(%s): %d net entries kept fresh init, %d checkpoint "
                           "entries unused" % (path, stats["kept_template"], stats["dropped"]),
                           "valid")
        return stats

    # -- subnet sampling (host, reference seed contract) ----------------------

    def sample_archs(self, epoch, n_batch, batch_idx, constraints=None,
                     fixed_cfg: Optional[SubnetConfig] = None):
        """The step's `dynamic_batch_size` subnets: draw k from
        subnet_seed(epoch, n_batch, batch_idx, k); with the sandwich rule,
        k=0 is the constraints' max corner (no draw); `fixed_cfg` pins
        every one."""
        sp = self.net.space
        n_trunks = self.net.n_trunks
        cons = constraints or {}
        rc = self.run_config
        sandwich = rc.sandwich_rule and fixed_cfg is None and rc.dynamic_batch_size >= 2
        cfgs = []
        for k in range(rc.dynamic_batch_size):
            if fixed_cfg is not None:
                cfg = fixed_cfg
            elif sandwich and k == 0:
                cfg = uniform_subnet(
                    sp,
                    max(cons.get("ks_candidates") or sp.ks_list),
                    max(cons.get("expand_candidates") or sp.expand_list),
                    max(cons.get("depth_candidates") or sp.depth_list),
                    max(cons.get("pixel_d_candidates") or sp.pixel_d_list), n_trunks=n_trunks)
            else:
                cfg = sample_subnet(sp, seed=subnet_seed(epoch, n_batch, batch_idx, k),
                                    n_trunks=n_trunks, **cons)
            cfgs.append(self._quirk_cfg(cfg))
        return cfgs

    def _quirk_cfg(self, cfg):
        if cfg is None or not self.run_config.reference_quirks:
            return cfg
        return (reference_quirk_arch_x4 if self.net.n_trunks == 2
                else reference_quirk_arch_s4)(cfg)

    # -- train / validate -----------------------------------------------------

    def train_one_epoch(self, epoch, constraints=None, fixed_cfg=None):
        """One epoch of steps; returns (mean loss, mean PSNR) over every
        step, weighted by batch size."""
        rc = self.run_config
        loader = self.provider.train
        loader.set_epoch(epoch)
        n_batch = len(loader)
        sums, n_seen = None, 0
        t0 = time.time()
        for i, batch in enumerate(loader):
            if i == 0 and rc.mode != "autoencoder":
                # a paired dataset emits one xN key: sample only the pixel_d
                # whose input exists (the autoencoder reads the HR frame)
                avail = [pd for pd in self.net.space.pixel_d_list
                         if "x%d" % (2 ** pd) in batch]
                if avail and set(avail) != set(self.net.space.pixel_d_list):
                    constraints = dict(constraints or {})
                    existing = constraints.get("pixel_d_candidates")
                    merged = [p for p in (existing or avail) if p in avail]
                    constraints["pixel_d_candidates"] = merged or avail
            lr = lr_at_step(rc.base_lr, epoch, i, n_batch, rc.n_epochs,
                            warmup_epochs=rc.warmup_epochs, warmup_lr=rc.warmup_lr,
                            lr_schedule_type=rc.lr_schedule_type)
            cfgs = self.sample_archs(epoch, n_batch, i, constraints, fixed_cfg)
            m = self.trainer.train_step(self._to_device(batch, shard=True), cfgs, lr)
            n = batch["image"].shape[0]
            step = torch.stack([m["loss"], m["psnr"]]) * n
            sums = step if sums is None else sums + step
            n_seen += n
            if (i + 1) % rc.print_frequency == 0 or i + 1 == n_batch:
                self.write_log(
                    "Train [%d][%d/%d]\tloss %.5f\tpsnr %.3f\tlr %.3g\t%s\t%.1fs"
                    % (epoch + 1, i + 1, n_batch, float(m["loss"]), float(m["psnr"]), lr,
                       cfgs[0].describe()[:48], time.time() - t0),
                    prefix="train", should_print=False)
        if sums is None:
            return 0.0, 0.0
        loss, psnr = (s / n_seen for s in sums.tolist())
        return loss, psnr

    def validate(self, cfg: Optional[SubnetConfig] = None, loader=None,
                 recalib_loader=None, frame_log: Optional[str] = None):
        """Mean loss and PSNR over the loader for one subnet (the max one by
        default). With bn_recalib_before_eval and a `recalib_loader`, the
        running statistics are recalibrated for this evaluation and restored
        after it. `frame_log`: a JSONL file receiving {"frame", "loss",
        "psnr"} per batch."""
        rc = self.run_config
        cfg = cfg or max_subnet(self.net.space, self.net.n_trunks)
        loader = loader if loader is not None else self.provider.test
        saved = None
        if rc.bn_recalib_before_eval and recalib_loader is not None:
            saved = {k: v.clone() for k, v in self.net.state_dict().items() if "running" in k}
            bn_recalibrate(self.net, cfg, cfg.pixel_d, recalib_loader,
                           use_kernels=self.trainer.use_kernels, mode=rc.mode, mesh=self.mesh)
        step = self.trainer.bucketed_eval_step if rc.eval_bucket else self.trainer.eval_step
        losses, psnrs = AverageMeter(), AverageMeter()
        log_f = open(frame_log, "a") if frame_log else None
        try:
            for fi, batch in enumerate(loader):
                if rc.eval_bucket:
                    batch = _bucket_pad(batch, cfg.pixel_d, rc.eval_bucket, rc.mode)
                out = step(self._to_device(batch), cfg)
                n = batch["image"].shape[0]
                lo, p = float(out["loss"]), float(out["psnr"])
                losses.update(lo, n)
                psnrs.update(p, n)
                if log_f is not None:
                    log_f.write(json.dumps({"frame": fi, "loss": lo, "psnr": p}) + "\n")
        finally:
            if log_f is not None:
                log_f.close()
            if saved is not None:
                self.net.load_state_dict(saved, strict=False)
        return losses.avg, psnrs.avg

    def gate_corners(self, named_psnrs, *, where):
        """Per-corner best gating (RunConfig.corner_gate): for each
        (corner_name, psnr) that beats the corner's recorded best, save the
        weights as best_<corner>.pth.tar and record the PSNR and `where` in
        corner_best.json. Never touches the rolling checkpoint, latest.txt
        or best_acc. Rank 0 alone under a mesh."""
        if not self.run_config.corner_gate or not self.writer:
            return
        sidecar = os.path.join(self.save_path, "corner_best.json")
        book = {}
        if os.path.exists(sidecar):
            try:
                with open(sidecar) as f:
                    book = json.load(f)
            except (OSError, ValueError):
                book = {}
        changed = False
        for name, psnr in named_psnrs:
            if psnr > book.get(name, {}).get("psnr", -1e9):
                save_weights(self.save_path, self.net.state_dict(), "best_%s.pth.tar" % name)
                book[name] = {"psnr": round(float(psnr), 3), "where": where}
                changed = True
        if changed:
            tmp = sidecar + ".tmp"
            with open(tmp, "w") as f:
                json.dump(book, f, indent=1)
            os.replace(tmp, sidecar)

    def train(self, validate_cfgs=None, constraints=None,
              fixed_cfg: Optional[SubnetConfig] = None):
        """Epoch loop from start_epoch, periodic validation and
        best-checkpoint gating. `validate_cfgs` entries are SubnetConfigs or
        (name, SubnetConfig) pairs (names feed corner gating)."""
        rc = self.run_config
        for epoch in range(self.start_epoch, rc.n_epochs + rc.warmup_epochs):
            t0 = time.time()
            tr_loss, tr_psnr = self.train_one_epoch(epoch, constraints, fixed_cfg)
            log = "Epoch %d: train loss %.5f, psnr %.3f (%.1fs)" % (
                epoch + 1, tr_loss, tr_psnr, time.time() - t0)
            if (epoch + 1) % rc.validation_frequency == 0:
                named = [c if isinstance(c, tuple) else ("cfg%d" % i, c)
                         for i, c in enumerate(validate_cfgs or [None])]
                vals = [self.validate(self._quirk_cfg(c)) for _, c in named]
                mean_psnr = float(np.mean([v[1] for v in vals]))
                self.gate_corners([(n, v[1]) for (n, _), v in zip(named, vals)],
                                  where="epoch %d" % (epoch + 1))
                is_best = mean_psnr > self.best_acc
                self.best_acc = max(self.best_acc, mean_psnr)
                log += " | valid psnr %.3f (best %.3f)" % (mean_psnr, self.best_acc)
                self.write_log(log, "valid")
                self.save_model(epoch=epoch, is_best=is_best)
            else:
                self.write_log(log, "train")
                if ((epoch + 1) % rc.save_frequency == 0
                        or epoch + 1 == rc.n_epochs + rc.warmup_epochs):
                    self.save_model(epoch=epoch)
        return self.best_acc

    def reset_running_statistics(self, cfg: SubnetConfig, n_images=2000, batch_size=100):
        """Recalibrate the running statistics for `cfg` over the provider's
        calibration subset, in `bn_recalibrate`'s default mode "sr" whatever
        the run's mode (an X4 net's decoder alone), on the HR "image"
        batch, as the JAX package's does. `validate`'s
        `recalib_loader` recalibrates in the run's mode instead."""
        loader = self.provider.build_sub_train_loader(n_images, batch_size)
        bn_recalibrate(self.net, cfg, cfg.pixel_d, loader, use_kernels=self.trainer.use_kernels,
                       mesh=self.mesh)
