"""Optimizer factory (counterpart of ofa_sr_tpu/train/optim.py): Adam, or SGD
with (Nesterov) momentum, with torch-style L2 weight decay (the decay joins
the gradient before the moment updates) and the reference's `bn#bias`
two-group split: parameters whose name contains "bn" or "bias" get no decay.
The kernel-transform matrices (`*_matrix`) contain neither and are decayed,
as the reference does.

The JAX package rebuilds torch's skip-untouched semantics by hand (`TorchOpt`
with a `sr_touched_mask`); here they are native: the trainer zeroes grads
with `set_to_none=True`, a module no sampled subnet executed keeps
`grad is None`, and torch's optimizers skip such a parameter entirely (no
decay, no moment update, no step count). `train/touched.py` has no
counterpart for that reason.
"""

from __future__ import annotations

import torch

NO_DECAY_KEYS = ("bn", "bias")


def param_groups(net, weight_decay):
    """[decayed, not decayed] parameter groups by name."""
    decay, no_decay = [], []
    for name, p in net.named_parameters():
        (no_decay if any(k in name for k in NO_DECAY_KEYS) else decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def build_optimizer(net, opt_type="adam", weight_decay=0.0, momentum=0.9,
                    nesterov=True, lr=0.0):
    """torch.optim.Adam (betas 0.9/0.999, eps 1e-8) or SGD(momentum,
    nesterov) over `param_groups`. The trainer sets each step's lr."""
    groups = param_groups(net, weight_decay)
    if opt_type == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if opt_type == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum, nesterov=nesterov)
    raise NotImplementedError(opt_type)
