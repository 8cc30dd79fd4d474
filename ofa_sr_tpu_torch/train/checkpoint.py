"""Checkpoints of the port, and the weight bridge from the JAX package.

The store (counterpart of the native half of
ofa_sr_tpu/train/checkpoint.py): one `torch.save` file per checkpoint
holding {"epoch", "best_acc", "model": state_dict, "optimizer":
state_dict}, `latest.txt` naming the newest, and `model_best.pth.tar`
holding {"model"} on a new best. The port does not read the JAX package's
msgpack checkpoints (the bridge below covers weights), but it reads a
reference `.pth.tar` or a raw state_dict: the port's state_dict has the
reference layout.

The bridge (counterpart of the torch-interop half, whose `import_torch_s4`
reads the port's `state_dict()` unchanged) goes the other direction: the
JAX package's `(params, state)` for OFAMobileNetS4, as numpy arrays (or
anything `np.asarray` takes), become a state_dict that
`OFAMobileNetS4.load_state_dict` accepts. Conv kernels HWIO -> OIHW;
depthwise [k,k,1,C] -> [C,1,k,k]; BN scale/bias/mean/var ->
weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import os

import numpy as np
import torch

CHECKPOINT_NAME = "checkpoint.pth.tar"
BEST_NAME = "model_best.pth.tar"


def save_checkpoint(save_dir, ckpt, *, name=CHECKPOINT_NAME, is_best=False,
                    best_name=BEST_NAME):
    """Write `ckpt` (a dict with "model") to save_dir/name, point
    latest.txt at it, and on `is_best` write {"model"} to `best_name`."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    torch.save(ckpt, path)
    with open(os.path.join(save_dir, "latest.txt"), "w") as f:
        f.write(path + "\n")
    if is_best:
        torch.save({"model": ckpt["model"]}, os.path.join(save_dir, best_name))
    return path


def save_weights(save_dir, state_dict, name):
    """A weights-only checkpoint {"model"} (per-corner best gating); it
    leaves latest.txt alone, so resuming is unaffected."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    torch.save({"model": state_dict}, path)
    return path


def load_checkpoint(path_or_dir):
    """The checkpoint dict at a file, or at a directory's latest.txt."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        with open(os.path.join(path_or_dir, "latest.txt")) as f:
            path = f.read().strip()
    return torch.load(path, map_location="cpu", weights_only=True)


def _strip_prefixes(sd):
    """Reference state_dict keys as the port names them: no 'module.', and
    the dynamic layers' '.bn.bn.' / '.conv.conv.' / '.linear.linear.'
    nestings collapsed."""
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        k = k.replace(".bn.bn.", ".bn.")
        k = k.replace(".conv.conv.", ".conv.")
        k = k.replace(".linear.linear.", ".linear.")
        out[k] = v
    return out


def checkpoint_state_dict(ckpt):
    """The weights of a loaded checkpoint: the port's {"model"}, a reference
    {"state_dict"}, or a raw state_dict; reference key prefixes stripped."""
    for key in ("model", "state_dict"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    return _strip_prefixes(ckpt)


def load_weights_lenient(path_or_dir, net):
    """Warm-start `net` in place with the reference's strict=False load:
    tensors whose key and shape match are taken from the checkpoint; the
    rest of the net keeps its init. This is how checkpoints chain across
    elastic spaces (a ks [7] net has no transform matrices; another expand
    list gives other bank shapes).

    Returns {"kept_template": net entries left at their init,
    "dropped": checkpoint entries the net has no place for}."""
    raw = checkpoint_state_dict(load_checkpoint(path_or_dir))
    own = net.state_dict()
    kept = 0
    with torch.no_grad():
        for k, v in own.items():
            src = raw.get(k)
            if src is None or tuple(src.shape) != tuple(v.shape):
                kept += 1
                continue
            v.copy_(src)
    return {"kept_template": kept, "dropped": sum(1 for k in raw if k not in own)}


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _hwio_to_oihw(w):
    # also maps a depthwise [k,k,1,C] to torch's [C,1,k,k]
    return _tensor(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _put_bn(sd, prefix, p, s):
    sd[prefix + ".weight"] = _tensor(p["scale"])
    sd[prefix + ".bias"] = _tensor(p["bias"])
    sd[prefix + ".running_mean"] = _tensor(s["mean"])
    sd[prefix + ".running_var"] = _tensor(s["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _put_conv_layer(sd, prefix, p, s):
    sd[prefix + ".conv.weight"] = _hwio_to_oihw(p["conv"]["w"])
    _put_bn(sd, prefix + ".bn", p["bn"], s["bn"])


def _put_mbconv(sd, prefix, p, s):
    micp = prefix + ".mobile_inverted_conv"
    for part in ("inverted_bottleneck", "depth_conv", "point_linear"):
        _put_conv_layer(sd, "%s.%s" % (micp, part), p[part], s[part])
    for name, mat in p["depth_conv"].get("kt", {}).items():
        sd["%s.depth_conv.conv.%s_matrix" % (micp, name)] = _tensor(mat)


def s4_state_dict_from_jax(params, state):
    """JAX OFAMobileNetS4 (params, state) -> the port's state_dict."""
    sd = {}
    _put_conv_layer(sd, "dec_first_conv_block", params["dec_first_conv_block"],
                    state["dec_first_conv_block"])
    n_mb = len(params["blocks"])
    for i in range(n_mb):
        _put_mbconv(sd, "blocks.%d" % i, params["blocks"][i], state["blocks"][i])
    for i in range(len(params["dec_final_conv_blocks"])):
        _put_conv_layer(sd, "dec_final_conv_blocks.%d" % i,
                        params["dec_final_conv_blocks"][i],
                        state["dec_final_conv_blocks"][i])
    for i in range(len(params["shuffle_blocks"])):
        _put_conv_layer(sd, "blocks.%d" % (n_mb + i), params["shuffle_blocks"][i],
                        state["shuffle_blocks"][i])
    _put_conv_layer(sd, "dec_final_output_conv_block",
                    params["dec_final_output_conv_block"],
                    state["dec_final_output_conv_block"])
    return sd
