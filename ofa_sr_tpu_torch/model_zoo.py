"""Model zoo (counterpart of ofa_sr_tpu/model_zoo.py, the reference's
ofa/model_zoo.py).

`ofa_net(net_id)` builds the named OFA supernet; `ofa_specialized(net_id)`
builds a published specialized subnet from its net.config. The reference
downloads pretrained weights; nothing is downloaded here, so both take a
local checkpoint (the port's own, `train/checkpoint.py`, or a reference
`.pth.tar` state_dict, which the port's reference-layout state_dict loads
straight) and otherwise keep the seed-0 weights.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .models.ofa_cls import OFAMobileNetV3, OFAProxylessNASNets
from .train.checkpoint import load_weights_strict

SR_NET_IDS = ("ofa_s4_d234_e346_k357_pd12", "ofa_x4_d234_e346_k357_pd12")


def _catalog():
    """The published specialized-net catalog, the JAX package's list of
    ids (50: the reference's three FLOPs targets and its latency targets on
    ten devices). Each id encodes its published top-1 and deployment constraint:
    '<device>@<constraint>_top1@<acc>_finetune@<ep>'."""
    ids = ["flops@595M_top1@80.0_finetune@75",
           "flops@482M_top1@79.6_finetune@75",
           "flops@389M_top1@79.1_finetune@75"]
    for dev, entries in {
        "pixel1_lat": ["143ms:80.1:75", "132ms:79.8:75", "79ms:78.7:75", "58ms:76.9:75",
                       "40ms:74.9:25", "28ms:73.3:25", "20ms:71.4:25"],
        "pixel2_lat": ["62ms:75.8:25", "50ms:74.7:25", "35ms:73.4:25", "25ms:71.5:25"],
        "note10_lat": ["64ms:80.2:75", "50ms:79.7:75", "41ms:79.3:75", "30ms:78.4:75",
                       "22ms:76.6:25", "16ms:75.5:25", "11ms:73.6:25", "8ms:71.4:25"],
        "note8_lat": ["65ms:76.1:25", "49ms:74.9:25", "31ms:72.8:25", "22ms:70.4:25"],
        "s7edge_lat": ["88ms:76.3:25", "58ms:74.7:25", "41ms:73.1:25", "29ms:70.5:25"],
        "LG-G8_lat": ["24ms:76.4:25", "16ms:74.7:25", "11ms:73.0:25", "8ms:71.1:25"],
        "1080ti_gpu64": ["27ms:76.4:25", "22ms:75.3:25", "15ms:73.8:25", "12ms:72.6:25"],
        "v100_gpu64": ["11ms:76.1:25", "9ms:75.3:25", "6ms:73.0:25", "5ms:71.6:25"],
        "tx2_gpu16": ["96ms:75.8:25", "80ms:75.4:25", "47ms:72.9:25", "35ms:70.3:25"],
        "cpu_lat": ["17ms:75.7:25", "15ms:74.6:25", "11ms:72.0:25", "10ms:71.1:25"],
    }.items():
        for e in entries:
            ms, acc, ft = e.split(":")
            ids.append("%s@%s_top1@%s_finetune@%s" % (dev, ms, acc, ft))
    table = {}
    for nid in ids:
        top1 = float(nid.split("_top1@")[1].split("_")[0])
        note = nid.split("_top1@")[0].replace("@", " ")
        table[nid] = (top1, note)
    return table


SPECIALIZED_CATALOG = _catalog()


def ofa_net(net_id: str = "ofa_mbv3_d234_e346_k357_w1.0", checkpoint: Optional[str] = None,
            *, device="cuda"):
    """The named supernet on `device` (the reference's three classification
    ids, and the SR ids 'ofa_s4_d234_e346_k357_pd12' (decoder-only SR) and
    'ofa_x4_d234_e346_k357_pd12' (downscale + SR autoencoder)), with its
    seed-0 weights or those of `checkpoint` (a file, or a run's checkpoint
    directory through its latest.txt: the port's {"model"}, a reference
    {"state_dict"} or a raw state_dict, loaded strictly)."""
    if net_id.startswith(("ofa_s4", "ofa_x4")):
        from .models import OFAMobileNetS4, OFAMobileNetX4, SearchSpace

        if net_id not in SR_NET_IDS:
            raise ValueError("unknown SR supernet id %r (supported: %s; build "
                             "OFAMobileNetS4/X4 with a custom SearchSpace directly for other "
                             "spaces)" % (net_id, ", ".join(SR_NET_IDS)))
        cls = OFAMobileNetS4 if net_id.startswith("ofa_s4") else OFAMobileNetX4
        net = cls(SearchSpace(), device=device)  # ks 3/5/7, e 3/4/6, d 2/3/4, pixel_d 1/2
    elif net_id.startswith(("ofa_proxyless", "ofa_mbv3")):
        # e.g. ofa_proxyless_d234_e346_k357_w1.3
        wm = float(net_id.split("_w")[-1]) if "_w" in net_id else 1.0
        cls = OFAProxylessNASNets if net_id.startswith("ofa_proxyless") else OFAMobileNetV3
        net = cls(ks_list=(3, 5, 7), expand_list=(3, 4, 6), depth_list=(2, 3, 4),
                  width_mult=wm, device=device)
    else:
        raise ValueError("unknown net_id: %s" % net_id)
    return load_weights_strict(checkpoint, net) if checkpoint else net


def ofa_specialized(net_id: str, root: Optional[str] = None, net_config=None,
                    init: Optional[str] = None, supernet=None, arch=None, *, device="cuda"):
    """(static net, expected) for a catalog id: the specialized
    architecture built from one of
    - `root`: a local mirror of the reference's download directory,
      <root>/<net_id>/net.config (+ run.config's image_size, + the 'init'
      weights if present);
    - `net_config`: a net.config dict or JSON path (+ optional `init`
      weights);
    - `supernet` (an ElasticClassifierNet) and `arch`: the subnet sliced
      out of a trained supernet.
    `expected` holds the published top-1, the constraint and the image
    size."""
    from .models.net_config import build_from_config, import_torch_static, specialize

    if net_id not in SPECIALIZED_CATALOG:
        raise ValueError("unknown specialized net: %s\nknown: %s"
                         % (net_id, sorted(SPECIALIZED_CATALOG)))
    expected_top1, note = SPECIALIZED_CATALOG[net_id]
    expected = {"top1": expected_top1, "note": note, "image_size": 224}

    if root is not None:
        base = os.path.join(root, net_id)
        with open(os.path.join(base, "net.config")) as f:
            net_config = json.load(f)
        run_cfg = os.path.join(base, "run.config")
        if os.path.exists(run_cfg):
            with open(run_cfg) as f:
                expected["image_size"] = json.load(f).get("image_size", 224)
        init_path = os.path.join(base, "init")
        if init is None and os.path.exists(init_path):
            init = init_path

    if net_config is not None:
        if isinstance(net_config, str):
            with open(net_config) as f:
                net_config = json.load(f)
        static = build_from_config(net_config, device=device)
        if init is not None:
            import_torch_static(init, static)
        return static, expected

    if supernet is not None and arch is not None:
        return specialize(supernet, arch), expected

    raise ValueError(
        "ofa_specialized needs an architecture source: pass root= (a local mirror of the "
        "reference's .torch/ofa_specialized download directory), net_config= (a net.config "
        "dict or JSON path), or supernet= and arch= (slice from a trained supernet)")
