"""Learning-rate schedules with the reference's exact formulas (the port's
own copy of ofa_sr_tpu/train/schedules.py, pure Python).

Reference: RunConfig.calc_learning_rate / warmup_adjust_learning_rate
(run_manager.py:67-90). Cosine over total steps, linear warmup counted in
steps with T_cur = epoch*nBatch + batch + 1. Entry scripts resolve
`warmup_lr < 0` to `base_lr` (train_teacher_net_sr_simple.py:163-164), i.e.
a constant-lr warmup.
"""

from __future__ import annotations

import math


def calc_learning_rate(init_lr, epoch, batch, n_batch, n_epochs,
                       lr_schedule_type="cosine"):
    """Post-warmup LR (run_manager.py:68-76). `epoch` is already
    warmup-shifted (caller passes epoch - warmup_epochs)."""
    if lr_schedule_type == "cosine":
        t_total = n_epochs * n_batch
        t_cur = epoch * n_batch + batch
        return 0.5 * init_lr * (1 + math.cos(math.pi * t_cur / t_total))
    elif lr_schedule_type is None:
        return init_lr
    raise ValueError("do not support: %s" % lr_schedule_type)


def warmup_learning_rate(init_lr, warmup_lr, epoch, batch, n_batch,
                         warmup_epochs):
    """Linear warmup (run_manager.py:85-90): T_cur/T_total*(init-warmup)+warmup
    with T_cur = epoch*nBatch + batch + 1."""
    t_total = warmup_epochs * n_batch
    t_cur = epoch * n_batch + batch + 1
    return t_cur / t_total * (init_lr - warmup_lr) + warmup_lr


def lr_at_step(init_lr, epoch, batch, n_batch, n_epochs, *,
               warmup_epochs=0, warmup_lr=-1, lr_schedule_type="cosine"):
    """The LR the reference trainer sets before a given (epoch, batch)
    (sr_run_manager.py:442-447 / progressive_shrinking.py:129-136)."""
    if warmup_lr < 0:
        warmup_lr = init_lr  # script convention (train_teacher_net_sr_simple.py:163-164)
    if epoch < warmup_epochs:
        return warmup_learning_rate(init_lr, warmup_lr, epoch, batch, n_batch,
                                    warmup_epochs)
    return calc_learning_rate(init_lr, epoch - warmup_epochs, batch, n_batch,
                              n_epochs, lr_schedule_type)
