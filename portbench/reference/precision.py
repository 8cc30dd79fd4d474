"""The precisions a reference computes in: float32, float64 (to see how
far float32 itself lies from the exact result), and the controls one step
below a configuration's type, emulated so that they read the same on any
device:

- TF32 for a float32 configuration: each product's operands rounded to
  TF32's 10-bit mantissa (ties to even), the sums and the results float32,
  as the tensor cores' TF32 mode computes; the gradient passes straight
  through.
- fp8 (e4m3) for a bf16 one: as a bf16 step computes in bf16, every
  product's operands and results are rounded to fp8 (one scale a tensor,
  its largest magnitude at e4m3's largest value), and so is every gradient
  that flows back through them.

`ROUNDINGS[name]` is (the rounding of a product's operands, that of its
result)."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def identity(t):
    return t


def _fp8_round(t):
    amax = t.abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


def fp8(t):
    """`t` rounded to fp8, and its gradient rounded to fp8 on the way back."""
    return _FP8.apply(t)


def tf32(t):
    """`t` (float32) rounded to the nearest TF32 value, the gradient passed
    straight through."""
    bits = t.detach().float().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    q = ((bits + bias) & ~0x1FFF).view(torch.float32).to(t.dtype)
    return t + (q - t.detach())


ROUNDINGS = {"float32": (identity, identity), "float64": (identity, identity),
             "tf32": (tf32, identity), "fp8": (fp8, fp8)}
DTYPES = {"float64": torch.float64}
