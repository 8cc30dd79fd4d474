"""The published optimizers over a reference's named parameters: torch's
Adam or SGD with Nesterov momentum, L2 weight decay joined to the gradient,
and the published `bn#bias` split: a parameter whose name holds "bn" or
"bias" is not decayed. torch skips a parameter whose gradient is None (a
module no sampled subnet ran): no decay, no moment, no step."""

from __future__ import annotations

import torch

NO_DECAY = ("bn", "bias")


def make_optimizer(named, opt):
    """`named`: [(name, leaf tensor)]; `opt`: the traffic's optimizer
    ({"type": "adam" | "sgd", "weight_decay", "momentum", "nesterov"})."""
    decay = [p for n, p in named if not any(k in n for k in NO_DECAY)]
    rest = [p for n, p in named if any(k in n for k in NO_DECAY)]
    groups = [{"params": decay, "weight_decay": opt["weight_decay"]},
              {"params": rest, "weight_decay": 0.0}]
    if opt["type"] == "adam":
        return torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    if opt["type"] == "sgd":
        return torch.optim.SGD(groups, lr=0.0, momentum=opt["momentum"],
                               nesterov=opt["nesterov"], foreach=False)
    raise ValueError("optimizer %r" % opt["type"])


def decay_of(name, opt):
    return 0.0 if any(k in name for k in NO_DECAY) else opt["weight_decay"]


def run_steps(named, loss_of_step, n_steps, lrs, opt):
    """`n_steps` optimizer steps; `loss_of_step(i)` runs step i's subnets'
    forwards and backwards and returns their mean loss. Returns (each
    step's loss, {name: the first step's gradient as the optimizer takes
    it, decay joined}, {name: the parameter after the last step}) over the
    parameters the steps touched."""
    optim = make_optimizer(named, opt)
    losses, first_grad = [], {}
    for i in range(n_steps):
        optim.zero_grad(set_to_none=True)
        losses.append(float(loss_of_step(i)))
        if i == 0:
            first_grad = {n: (p.grad + decay_of(n, opt) * p.detach()).detach().clone()
                          for n, p in named if p.grad is not None}
        for g in optim.param_groups:
            g["lr"] = lrs[i]
        optim.step()
    return losses, first_grad, {n: p.detach() for n, p in named}
