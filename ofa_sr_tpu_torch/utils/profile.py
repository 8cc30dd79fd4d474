"""Profiling utilities (counterpart of ofa_sr_tpu/utils/profile.py).

- `get_net_info`: the parameter count and the closed-form subnet
  parameters and MACs of an SR supernet (also written to net_info.txt by
  the run manager);
- `measure_net_latency`: median wall-clock ms of eager calls
  (`search.latency.measure_latency`);
- `trace`: a context manager around `torch.profiler` that writes a device
  timeline (a Chrome trace, viewable in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..search.flops import s4_subnet_flops, s4_subnet_params
from ..search.latency import measure_latency as measure_net_latency  # noqa: F401 (re-export)


def get_net_info(net, cfg=None, hr_size=96):
    """{"param_count", "subnet_params", "subnet_macs"} of an SR supernet,
    the JAX package's dict for the same net (the subnet entries on an S4
    net only). `cfg` (a SubnetConfig) picks the subnet of the closed forms;
    None: the max subnet.

    "param_count" counts what the JAX package's params tree holds: the
    net's parameters (conv weights, BN scales and biases, the kernel
    transform matrices), not its buffers (BN running statistics and
    `num_batches_tracked`), which JAX keeps in its state tree.
    `search.flops.count_params` of the module still counts the buffers, and
    of a `StaticSubnet.params` dict it still skips the blocks' "ks" and
    "mid" ints, which JAX's leaf count includes (a stated difference,
    ROADMAP queue 3)."""
    from ..models.arch import max_subnet
    info = {"param_count": sum(int(np.prod(p.shape)) for p in net.parameters())}
    space = net.space
    if cfg is None:
        cfg = max_subnet(space, net.n_trunks)
    if net.n_trunks == 1:
        info["subnet_params"] = s4_subnet_params(cfg, space, net.CONV_KS)
        info["subnet_macs"] = s4_subnet_flops(cfg, space, hr_size, net.CONV_KS)
    return info


@contextlib.contextmanager
def trace(logdir: str = "ofa_sr_tpu_torch_trace"):
    """Capture a device timeline: `with profile.trace(dir): step(...)`.
    Records CPU and (where there is a GPU) CUDA activity and writes one
    Chrome trace, `<logdir>/trace_<time>.json`, on exit; yields `logdir`."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace_%d.json" % time.time_ns()))
