"""Optimizer factory (counterpart of ofa_sr_tpu/train/optim.py): Adam, or SGD
with (Nesterov) momentum, with torch-style L2 weight decay (the decay joins
the gradient before the moment updates) and the reference's `bn#bias`
two-group split: parameters whose name contains "bn" or "bias" get no decay.
The kernel-transform matrices (`*_matrix`) contain neither and are decayed,
as the reference does.

The eager step gets torch's skip-untouched semantics natively: the trainer
zeroes grads with `set_to_none=True`, a module no sampled subnet executed
keeps `grad is None`, and torch's optimizers skip such a parameter entirely
(no decay, no moment update, no step count). The graphed step's gradients
are static zero-filled tensors, which cannot be None, so it runs
`GatedOpt`: the same update on the device, gated per parameter by the
step's touched mask (`train/touched.py`), the JAX package's `TorchOpt` with
`touched`.
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


class GatedOpt:
    """torch.optim.Adam / SGD(momentum, nesterov) over flat device buffers,
    each parameter gated by a touched flag (the JAX package's
    `TorchOpt.update(..., touched)`): an untouched parameter gets no decay,
    no moment update and no step count, as torch skips a None grad.

    It takes over `opt` (a `build_optimizer` optimizer): its parameter
    groups, hyperparameters and state, which it keeps as flat float32
    buffers in the groups' order: `grad` (each parameter's `.grad` is a view
    of it, so backward accumulates in place), the moments (Adam) or the
    momentum buffer (SGD), and per parameter a step count `steps`, a float32
    device vector. `touched` (bool, one a parameter) and `lr` (0-d) are
    device buffers read by `update`, so a captured update serves every
    step. `state_dict` / `load_state_dict` read and write the layout of
    `opt`'s own (an entry only for a parameter stepped at least once), so a
    checkpoint resumes with either optimizer. `zero_grad` and `step` are
    torch's, for the eager step: a None grad is untouched."""

    def __init__(self, opt):
        if not isinstance(opt, (torch.optim.Adam, torch.optim.SGD)):
            raise NotImplementedError("GatedOpt takes torch.optim.Adam or SGD, got %s"
                                      % type(opt).__name__)
        self.opt = opt
        self.adam = isinstance(opt, torch.optim.Adam)
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.sizes = [p.numel() for p in self.params]
        dev = self.params[0].device
        n = sum(self.sizes)
        self.grad = torch.zeros(n, device=dev)
        self.grad_views = [g.view_as(p) for g, p in zip(self.grad.split(self.sizes),
                                                         self.params)]
        # element -> its parameter's index, to spread per-parameter values
        self.owner = torch.repeat_interleave(torch.arange(len(self.params)),
                                             torch.tensor(self.sizes)).to(dev)
        self.decay = torch.tensor([float(g["weight_decay"]) for g in opt.param_groups
                                   for _ in g["params"]], device=dev)[self.owner]
        self.steps = torch.zeros(len(self.params), device=dev)
        self.touched = torch.ones(len(self.params), dtype=torch.bool, device=dev)
        self.lr = torch.zeros((), device=dev)
        self.state = [torch.zeros(n, device=dev) for _ in range(2 if self.adam else 1)]
        self._pull_state()

    @property
    def param_groups(self):
        return self.opt.param_groups

    def attach_grads(self):
        """Point every parameter's `.grad` at its view of the flat buffer."""
        for p, g in zip(self.params, self.grad_views):
            p.grad = g

    def update(self, clip_grad_norm=None):
        """One step of every touched parameter from the flat gradients, on
        the device and without reading anything back: torch's
        `clip_grad_norm_` first where given, then the decay joins the
        gradient, then Adam (`lerp` of the first moment, bias corrections
        from the per-parameter step counts) or SGD; the gradients are
        zeroed after."""
        h = self.opt.param_groups[0]
        with torch.no_grad():
            g = self.grad
            if clip_grad_norm:
                norm = torch.linalg.vector_norm(g)
                g = g * torch.clamp(clip_grad_norm / (norm + 1e-6), max=1.0)
            p = torch.cat([q.detach().reshape(-1) for q in self.params])
            live = self.touched[self.owner]
            g = g + self.decay * p
            steps = self.steps + self.touched.float()
            if self.adam:
                (b1, b2), eps = h["betas"], h["eps"]
                m0, v0 = self.state
                m = torch.lerp(m0, g, 1 - b1)
                v = torch.addcmul(v0 * b2, g, g, value=1 - b2)
                step_size = (self.lr / (1 - torch.pow(b1, steps)))[self.owner]
                bc2_sqrt = torch.sqrt(1 - torch.pow(b2, steps))[self.owner]
                new_p = p - step_size * m / (torch.sqrt(v) / bc2_sqrt + eps)
                new_state = (m, v)
            else:
                mu = h["momentum"]
                buf = self.state[0] * mu + g
                new_p = p - self.lr * (g + mu * buf if h["nesterov"] else buf)
                new_state = (buf,)
            for old, new in zip(self.state, new_state):
                old.copy_(torch.where(live, new, old))
            new_p = torch.where(live, new_p, p)
            self.steps.copy_(steps)
            torch._foreach_copy_(self.params, [t.view_as(q) for t, q in
                                               zip(new_p.split(self.sizes), self.params)])
            self.grad.zero_()

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def step(self):
        """torch's step on the present gradients: a parameter whose grad is
        None is untouched; the lr is the groups' (one for both)."""
        with torch.no_grad():
            present = [p.grad is not None for p in self.params]
            flat = torch.cat([p.grad.reshape(-1) if p.grad is not None else g.new_zeros(n)
                              for p, g, n in zip(self.params, self.grad_views, self.sizes)])
            self.grad.copy_(flat)
            self.touched.copy_(torch.tensor(present))
            self.lr.fill_(self.opt.param_groups[0]["lr"])
        self.update()

    def _slices(self, flat):
        return [t.view_as(p) for t, p in zip(flat.split(self.sizes), self.params)]

    def _pull_state(self):
        """`opt`'s state (torch's layout) into the flat buffers; `opt`
        keeps none of its own."""
        keys = ("exp_avg", "exp_avg_sq") if self.adam else ("momentum_buffer",)
        with torch.no_grad():
            for i, p in enumerate(self.params):
                st = self.opt.state.get(p)
                if not st:
                    continue
                for buf, key in zip(self.state, keys):
                    self._slices(buf)[i].copy_(st[key])
                self.steps[i] = float(st["step"]) if self.adam else 1.0
        self.opt.state.clear()

    def state_dict(self):
        """`opt.state_dict()`'s layout: an entry for each parameter stepped
        at least once (Adam: step as a float32 CPU tensor, exp_avg,
        exp_avg_sq; SGD: momentum_buffer)."""
        keys = ("exp_avg", "exp_avg_sq") if self.adam else ("momentum_buffer",)
        slices = [self._slices(buf) for buf in self.state]
        for i, (p, n) in enumerate(zip(self.params, self.steps.tolist())):
            if n > 0:
                st = {k: s[i].clone() for k, s in zip(keys, slices)}
                if self.adam:
                    st = dict(step=torch.tensor(n, dtype=torch.float32), **st)
                self.opt.state[p] = st
        try:
            return self.opt.state_dict()
        finally:
            self.opt.state.clear()

    def load_state_dict(self, state_dict):
        self.opt.load_state_dict(state_dict)
        for buf in self.state:
            buf.zero_()
        self.steps.zero_()
        self._pull_state()
