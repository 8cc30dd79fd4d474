"""Entry points of the port.

`entry()` is the counterpart of the JAX package's `__graft_entry__.entry`:
the flagship OFAMobileNetS4 supernet (full search space) in an eval forward
of a sampled subnet at batch 16, 48x48 LR, pixel_d 1.

`serve(frames, ...)` is the serving path: it materializes a static subnet
(default ks7/e6/d2/pixel_d 2, the reference eval envelope) and answers LR
frames one at a time, like the JAX package's
`cli/eval_ofa_net_sr.py --materialize`.

Both run on the GPU unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from .models.arch import SearchSpace, SubnetConfig, sample_subnet, uniform_subnet
from .models.materialize import get_active_subnet
from .models.ofa_s4 import OFAMobileNetS4
from .utils.device import resolve_device


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) is the supernet eval forward."""
    dev = resolve_device(device)
    space = SearchSpace()  # ks 3/5/7, e 3/4/6, d 2/3/4, pixel_d 1/2
    net = OFAMobileNetS4(space, device=dev)
    cfg = sample_subnet(space, seed=0)
    x2 = torch.from_numpy(
        np.random.RandomState(0).rand(16, 48, 48, 3).astype(np.float32)).to(dev)

    def fn(net, x2, cfg):
        with torch.inference_mode():
            return net(x2, cfg, pixel_d=1)

    return fn, (net, x2, cfg)


def serve(frames: Iterable, *, net: Optional[OFAMobileNetS4] = None,
          cfg: Optional[SubnetConfig] = None, device="cuda") -> List[torch.Tensor]:
    """Super-resolve LR frames one at a time through a materialized subnet.

    frames: NHWC float arrays or tensors, (1,H,W,3) or (H,W,3).
    net: the supernet to slice (default: a seed-0 full-width OFAMobileNetS4
    on `device`). cfg: the subnet (default ks7/e6/d2/pixel_d 2). On a CUDA
    device the subnet runs the hand-written kernels.
    Returns the HR frames, (1, H*2^pd, W*2^pd, 3) tensors on `device`.
    """
    dev = resolve_device(device)
    if net is None:
        net = OFAMobileNetS4(SearchSpace(), device=dev)
    elif net.device != dev:
        raise ValueError("net is on %s, serve was asked for %s" % (net.device, dev))
    if cfg is None:
        cfg = uniform_subnet(net.space, 7, 6, 2, 2)
    subnet = get_active_subnet(net, cfg)
    out = []
    with torch.inference_mode():
        for frame in frames:
            x = torch.as_tensor(frame, dtype=torch.float32, device=dev)
            if x.ndim == 3:
                x = x[None]
            out.append(subnet(x.contiguous()))
    return out
