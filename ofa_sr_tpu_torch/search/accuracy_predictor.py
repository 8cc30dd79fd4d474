"""Accuracy/PSNR predictor MLP (counterpart of
ofa_sr_tpu/search/accuracy_predictor.py): Linear(in, hidden) + ReLU,
`n_layers` times, then Linear(hidden, 1), fitted on (encoding, metric)
pairs with normalized targets.

The weights start U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from a
`torch.Generator(seed)` with zero biases: the JAX package's law, not its
numbers (`jax.random` and `torch.Generator` differ). `from_jax_params`
carries the JAX predictor's weights over. `fit` is the JAX loop: Adam (PyTorch's
is optax.adam's arithmetic: b1 0.9, b2 0.999, eps 1e-8 outside the square
root), a `np.random.RandomState(seed)` permutation each epoch, MSE on
targets normalized by their mean and `np.std` + 1e-8.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device


class AccuracyPredictor(nn.Module):
    def __init__(self, in_dim, hidden=400, n_layers=3, seed=0, device="cuda"):
        super().__init__()
        self.in_dim, self.hidden, self.n_layers = in_dim, hidden, n_layers
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        dims = [in_dim] + [hidden] * n_layers + [1]
        layers = []
        for a, b in zip(dims[:-1], dims[1:]):
            lin = nn.Linear(a, b)
            std = 1.0 / np.sqrt(a)
            with torch.no_grad():
                lin.weight.copy_((torch.rand(b, a, generator=g) * 2 - 1) * std)
                lin.bias.zero_()
            layers.append(lin)
        self.layers = nn.ModuleList(layers).to(dev)
        self.device = dev
        # the targets' normalization, set by fit
        self.mu, self.sigma = 0.0, 1.0

    @classmethod
    def from_jax_params(cls, params, mu=0.0, sigma=1.0, device="cuda"):
        """The predictor holding a JAX predictor's weights: `params` its list
        of {"w": (a, b), "b": (b,)} arrays, `mu` and `sigma` its target
        normalization."""
        ws = [np.asarray(p["w"], np.float32) for p in params]
        pred = cls(ws[0].shape[0], hidden=ws[0].shape[1], n_layers=len(ws) - 1,
                   device=device)
        with torch.no_grad():
            for lin, p, w in zip(pred.layers, params, ws):
                lin.weight.copy_(torch.from_numpy(w.T.copy()))
                lin.bias.copy_(torch.from_numpy(np.array(p["b"], np.float32)))
        pred.mu, pred.sigma = float(mu), float(sigma)
        return pred

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x)[..., 0]

    def predict(self, feats):
        """Predicted metric for each row of `feats` (numpy in, numpy out)."""
        x = torch.as_tensor(np.atleast_2d(feats), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            out = self(x).cpu().numpy()
        return out * self.sigma + self.mu

    def fit(self, feats, targets, *, epochs=200, lr=1e-3, batch_size=256, seed=0):
        """Fit on (feature rows, metric) pairs; returns the last step's loss."""
        feats = np.asarray(feats, np.float32)
        targets = np.asarray(targets, np.float32)
        self.mu = float(targets.mean())
        self.sigma = float(targets.std() + 1e-8)
        y = (targets - self.mu) / self.sigma
        x_all = torch.from_numpy(feats).to(self.device)
        y_all = torch.from_numpy(y).to(self.device)
        opt = torch.optim.Adam(self.parameters(), lr=lr)
        rng = np.random.RandomState(seed)
        n = len(feats)
        loss = None
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n, batch_size):
                idx = torch.from_numpy(order[i:i + batch_size]).to(self.device)
                loss = torch.mean(torch.square(self(x_all[idx]) - y_all[idx]))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        return float("inf") if loss is None else float(loss.detach())
