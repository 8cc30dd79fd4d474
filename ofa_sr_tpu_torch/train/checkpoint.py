"""Weight bridge from the JAX package's pytrees to the port's state_dict.

Counterpart of the torch-interop half of ofa_sr_tpu/train/checkpoint.py
(which reads the reference state_dict layout into JAX pytrees:
`import_torch_s4` there reads the port's `state_dict()` unchanged). This is
the other direction: the JAX package's `(params, state)` for
OFAMobileNetS4, as numpy arrays (or anything `np.asarray` takes), become a
state_dict that `OFAMobileNetS4.load_state_dict` accepts.

Conv kernels HWIO -> OIHW; depthwise [k,k,1,C] -> [C,1,k,k]; BN
scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch


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
