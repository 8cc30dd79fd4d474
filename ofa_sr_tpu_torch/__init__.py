"""PyTorch/CUDA port of ofa_sr_tpu, for an NVIDIA H100.

The JAX package `ofa_sr_tpu` is the reference this package is held to; this
package never imports it (nor JAX). Module names mirror the JAX package's, so
each counterpart is found under the same path. Activations at public
functions keep JAX's NHWC layout; weights are held in PyTorch's OIHW layout
(the reference state_dict layout), except at the hand-written kernels'
interfaces, which take the same weight layouts as their Pallas counterparts.

Entry points (`entry.entry`, `entry.serve`) run on the GPU unless the caller
passes `device="cpu"`.
"""
