"""Ahead-of-time export of materialized subnets for serving (counterpart of
ofa_sr_tpu/models/export.py).

A materialized subnet (weights sliced and BN folded, elasticity gone:
`get_active_subnet`, `get_active_cls_subnet`) is traced once with
`torch.export` for one fixed input shape and written with
`torch.export.save`: one file that holds the weights and the program, which
`load_subnet` serves with PyTorch alone, without this package's model code.

The artifact holds the plain path (cuDNN and PyTorch ops), as the JAX
package's holds XLA and no Pallas: the hand-written kernels are bound
through ctypes (`ops/kernels/_build.py`), which `torch.export` cannot
trace. JAX's `platforms` (the lowerings one artifact embeds) has no
counterpart and is not a parameter here: a torch artifact is traced on one
device and `load_subnet(..., device=...)` moves it to another.
"""

from __future__ import annotations

import io
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .arch import SubnetConfig
from .materialize import get_active_subnet


class _Buffer(str):
    """The place of a tensor of a subnet's params tree: a buffer's name."""


class ServedSubnet(nn.Module):
    """A materialized subnet as an `nn.Module` for `torch.export`: every
    tensor of its `params` tree registered as a buffer (a copy with storage
    of its own: the sliced tensors are views of the supernet's, which the
    artifact would otherwise save whole), the tree rebuilt from the buffers
    at each call, so the traced program reads the weights as the module's
    state."""

    def __init__(self, subnet):
        super().__init__()
        self._subnet = subnet
        self._template = self._register(subnet.params)

    def _register(self, tree):
        if isinstance(tree, dict):
            return {k: self._register(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._register(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            name = _Buffer("w%d" % len(self._buffers))
            self.register_buffer(name, tree.detach().clone())
            return name
        return tree

    def _rebuild(self, tree):
        if isinstance(tree, dict):
            return {k: self._rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._rebuild(v) for v in tree)
        if isinstance(tree, _Buffer):
            return getattr(self, tree)
        return tree

    def forward(self, x):
        self._subnet.params = self._rebuild(self._template)
        return self._subnet(x)


class _FnModule(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _export(module, example, path):
    """torch.export the module for `example`'s shape; the artifact's bytes,
    also written to `path` when given."""
    with torch.no_grad():
        ep = torch.export.export(module, (example,), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_subnet(net, cfg: SubnetConfig, input_hw, *, batch: int = 1,
                  dtype=torch.float32, mode: str = "sr", fold_bn: bool = True,
                  path: Optional[str] = None) -> bytes:
    """Materialize `cfg` out of the SR supernet (the plain path) and export
    it for `(batch, *input_hw, 3)` inputs on the net's device: the LR frame
    in "sr" mode, the HR frame in "autoencoder" (an X4 net). Returns the
    artifact's bytes; also writes them to `path` when given."""
    subnet = get_active_subnet(net, cfg, fold_bn=fold_bn, mode=mode, use_kernels=False)
    example = torch.zeros(batch, input_hw[0], input_hw[1], 3, dtype=dtype, device=net.device)
    return _export(ServedSubnet(subnet), example, path)


def export_fn(fn, input_shape, *, dtype=torch.float32, device="cuda",
              path: Optional[str] = None) -> bytes:
    """Export any traceable `fn(x)` (an `nn.Module`, such as a static net
    from `net_config.specialize`, or a function) for one fixed input shape,
    traced on `device`. Tensors that a function closes over are saved as
    the program's constants."""
    module = fn if isinstance(fn, nn.Module) else _FnModule(fn)
    example = torch.zeros(tuple(input_shape), dtype=dtype, device=resolve_device(device))
    return _export(module, example, path)


def export_cls_subnet(net, arch, image_size: int, *, batch: int = 1, dtype=torch.float32,
                      fold_bn: bool = True, path: Optional[str] = None) -> bytes:
    """Classification twin of `export_subnet`: materialize `arch` (a
    ClsArch) out of an MBV3 or Proxyless supernet and export `fn(image) ->
    logits` for `(batch, image_size, image_size, 3)` inputs."""
    from .materialize_cls import get_active_cls_subnet

    subnet = get_active_cls_subnet(net, arch, fold_bn=fold_bn)
    example = torch.zeros(batch, image_size, image_size, 3, dtype=dtype, device=net.device)
    return _export(ServedSubnet(subnet), example, path)


def load_subnet(path_or_bytes, *, device="cuda"):
    """The exported program as a callable `fn(x) -> output` (a
    `torch.fx.GraphModule`) on `device`."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(bytes(path_or_bytes))
    elif isinstance(path_or_bytes, str):
        f = path_or_bytes
    else:
        raise TypeError("expected a path or serialized bytes")
    return torch.export.load(f).module().to(resolve_device(device))
