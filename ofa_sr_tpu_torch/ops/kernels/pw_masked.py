"""The masked MBConv's 1x1 expand and project convolutions bounded by the
sampled middle width: the JAX package's `expand_switch` lever
(`models.layers.set_expand_lever`) in the masked MBConv of the graphed
training step, as one hand-written CUDA GEMM family (csrc/pw_masked.cu)
that reads the width from the device.

    masked_pointwise(x, w, bound, *, side) -> y

x: NHWC [..., I]; w: the 1x1 bank [O, I, 1, 1] (OIHW); bound: a
one-element int32 device tensor, the middle width m (the nets pass the
sampled `mid`). `side` "expand" bounds the output channels (the expand
conv, O the bank's middle width M), "project" the input channels (the
project conv, I = M). The contract is the plain version,
`masked_pointwise_reference`: the sliced product padded with zeros,
written with a channel mask cm = channel_mask(m, M),

    expand:  y = (x @ w^T) * cm        y[..., m:] = 0
    project: y = (x * cm) @ w^T        x[..., m:] not read

and its autograd gives the kernel's gradients:

    expand:  dx = (dy * cm) @ w        dW = (dy * cm)^T . x   (rows from m on 0)
    project: dx = (dy @ w) * cm        dW = dy^T . (x * cm)   (columns from m on 0)

On the step's path this is the full-width conv's result exactly (JAX's
`_sliced_mbconv_branch` and its test, tests/test_expand_switch.py): the
masked BN after the expand writes 0 from `mid` on, so the expand's columns
from `mid` on and the project's input channels from `mid` on never count,
and their gradients are 0 on both paths.

`masked_pointwise` is a `torch.autograd.Function` whose three directions
are the kernel's entry points, each a public function with its own launch
counter: `pw_masked_forward`, `pw_masked_dgrad` and `pw_masked_wgrad`
(`.launches`, `.launches_bf16`: one a call of either side, the wgrad's two
launches included). A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version (`masked_pointwise_dgrad_reference` and
`masked_pointwise_wgrad_reference` for dx and dW, one product each) and
counts nothing. float32 (3xTF32) or bfloat16 activations and weights of
one type (bf16 results rounded once from float32 sums). Nothing reads `bound` on
the host, so a captured CUDA graph replays the same launches for every
subnet.

The wgrad sums over the rows in two passes with no atomics (fixed runs of
rows into float32 partials in a workspace this module allocates, then a
second kernel adding them in order), its partition (`wgrad_partition`)
chosen from the shapes alone: two calls on the same inputs give the same
bits on any card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..elastic import channel_mask
from . import _build

KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SIDES = ("expand", "project")
# the kernel's tiling (csrc/pw_masked.cu): a block owns BM x BN outputs and
# walks K in chunks of BK; every dimension but the rows a multiple of
# ALIGN_CH channels, every pointer 16-byte aligned
BM, BN, BK = 64, 64, 32
ALIGN_CH = 8
WGRAD_BLOCKS = 528        # wgrad pass-1 blocks aimed at: four an SM of 132


def _w2d(w):
    return w.reshape(w.shape[0], w.shape[1])


def _side(side):
    if side not in SIDES:
        raise ValueError("side must be one of %s, got %r" % (SIDES, side))
    return side == "project"


def masked_pointwise_reference(x, w, bound, *, side):
    """The plain version (module docstring), in x's type: cuBLAS's product
    on the card."""
    project = _side(side)
    w2 = _w2d(w)
    if project:
        return F.linear(x * channel_mask(bound, x.shape[-1], x.dtype, x.device), w2)
    return F.linear(x, w2) * channel_mask(bound, w2.shape[0], x.dtype, x.device)


def masked_pointwise_dgrad_reference(dy, w, bound, *, side):
    """dx of the plain version for the output cotangent dy, one product:
    (dy * cm) @ w (expand) or (dy @ w) * cm (project)."""
    w2 = _w2d(w)
    if _side(side):
        return (dy @ w2) * channel_mask(bound, w2.shape[1], dy.dtype, dy.device)
    return (dy * channel_mask(bound, w2.shape[0], dy.dtype, dy.device)) @ w2


def masked_pointwise_wgrad_reference(x, dy, bound, *, side):
    """dW [O, I, 1, 1] of the plain version for the output cotangent dy,
    one product over the rows: (dy * cm)^T . x (expand) or dy^T . (x * cm)
    (project)."""
    o, i = dy.shape[-1], x.shape[-1]
    x2, dy2 = x.reshape(-1, i), dy.reshape(-1, o)
    if _side(side):
        x2 = x2 * channel_mask(bound, i, x.dtype, x.device)
    else:
        dy2 = dy2 * channel_mask(bound, o, dy.dtype, dy.device)
    return (dy2.t() @ x2).view(o, i, 1, 1)


def masked_pointwise_grads_reference(x, w, bound, dy, *, side):
    """(dx, dW) of the plain version for the output cotangent dy, through
    its autograd (the reference the single products above are held to)."""
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    with torch.enable_grad():
        y = masked_pointwise_reference(x, w, bound, side=side)
        return torch.autograd.grad(y, (x, w), dy)


def wgrad_partition(rows, p, q):
    """(rows a pass-1 block sums, blocks G along the rows) for a wgrad of
    [rows, p] by [rows, q]: about WGRAD_BLOCKS blocks over the p x q tiles,
    each run a multiple of BK rows; from the shapes alone (the partials are
    added in this partition's order)."""
    tiles = -(-p // BM) * -(-q // BN)
    want = max(1, -(-WGRAD_BLOCKS // tiles))
    per = -(-(-(-rows // want)) // BK) * BK
    return per, -(-rows // per)


def _check(a, b, bound, *mats):
    """The launch operands' checks: a, b (activations, b may be None) and
    the 2-D matrices `mats` contiguous CUDA tensors of one kernel type,
    16-byte aligned, every channel dimension a multiple of ALIGN_CH; bound
    a one-element int32 tensor on the device. Returns the type's suffix."""
    dtype = a.dtype
    if dtype not in KERNEL_DTYPES:
        raise ValueError("the masked 1x1 kernel takes float32 or bfloat16; got %s" % (dtype,))
    tensors = {"a": a} if b is None else {"a": a, "b": b}
    tensors.update({"w%d" % i: m for i, m in enumerate(mats)})
    _build.require_cuda(a.device, dtype, **tensors)
    dims = [t.shape[-1] for t in tensors.values()] + [m.shape[0] for m in mats]
    if any(d % ALIGN_CH for d in dims):
        raise ValueError("the masked 1x1 kernel takes channel counts that are multiples of "
                         "%d; got %s" % (ALIGN_CH, dims))
    if any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError("the masked 1x1 kernel takes 16-byte aligned tensors")
    if bound.numel() != 1:
        raise ValueError("bound must be a one-element int32 tensor; got shape %s"
                         % (tuple(bound.shape),))
    _build.require_cuda(a.device, torch.int32, bound=bound)
    return KERNEL_DTYPES[dtype]


def _count(wrapper, suffix):
    wrapper.launches += 1
    if suffix == "bf16":
        wrapper.launches_bf16 += 1


def _gemm(a2, b2, bound, n, b_kn, bound_k, suffix):
    """C [R, n] = a2 [R, K] . op(b2) through the gemm entry point."""
    r, k = a2.shape
    c = torch.empty(r, n, device=a2.device, dtype=a2.dtype)
    _build.launch("ofa_pw_masked_gemm_" + suffix, a2.device, a2, b2, bound, c, r, k, n,
                  int(b_kn), int(bound_k))
    return c


def pw_masked_forward(x, w, bound, *, side):
    """y of the masked 1x1 conv (module docstring): the kernel for a CUDA x,
    the plain version for a CPU one."""
    if x.device.type == "cpu":
        return masked_pointwise_reference(x, w, bound, side=side)
    project = _side(side)
    x = x.contiguous()
    w2 = _w2d(w)
    if x.shape[-1] != w2.shape[1]:
        raise ValueError("x %s and a [O, I] bank %s" % (tuple(x.shape), tuple(w2.shape)))
    suffix = _check(x, None, bound, w2)
    # the forwards: B = w [O, I] stored [N, K]; bound on N (expand) or K (project)
    y = _gemm(x.view(-1, x.shape[-1]), w2, bound, w2.shape[0], False, project, suffix)
    _count(pw_masked_forward, suffix)
    return y.view(*x.shape[:-1], w2.shape[0])


def pw_masked_dgrad(dy, w, bound, *, side):
    """dx of the masked 1x1 conv for the output cotangent dy: the kernel for
    a CUDA dy, the plain version for a CPU one."""
    if dy.device.type == "cpu":
        return masked_pointwise_dgrad_reference(dy, w, bound, side=side)
    project = _side(side)
    w2 = _w2d(w)
    dy = dy.contiguous()
    if dy.shape[-1] != w2.shape[0]:
        raise ValueError("dy %s and a [O, I] bank %s" % (tuple(dy.shape), tuple(w2.shape)))
    suffix = _check(dy, None, bound, w2)
    # the dgrads: B = w [O, I] stored [K, N]; bound on N (project: dx's
    # columns) or K (expand: dy's columns)
    dx = _gemm(dy.view(-1, dy.shape[-1]), w2, bound, w2.shape[1], True, not project, suffix)
    _count(pw_masked_dgrad, suffix)
    return dx.view(*dy.shape[:-1], w2.shape[1])


def pw_masked_wgrad(x, dy, bound, *, side):
    """dW [O, I, 1, 1] of the masked 1x1 conv for the output cotangent dy:
    the kernel's two passes for CUDA tensors, in x's type; for CPU ones the
    plain version."""
    if x.device.type == "cpu":
        return masked_pointwise_wgrad_reference(x, dy, bound, side=side)
    o, i = dy.shape[-1], x.shape[-1]
    project = _side(side)
    x, dy = x.contiguous(), dy.contiguous()
    if x.shape[:-1] != dy.shape[:-1]:
        raise ValueError("x %s and dy %s differ in their rows" % (tuple(x.shape),
                                                                  tuple(dy.shape)))
    suffix = _check(x, dy, bound)
    x2, dy2 = x.view(-1, i), dy.view(-1, o)
    # out = A^T . B with the bound on A's columns: expand dY^T . X [M, Cin];
    # project (H^T . dZ)^T [Cout, M]
    a, b = (x2, dy2) if project else (dy2, x2)
    rows, p, q = a.shape[0], a.shape[1], b.shape[1]
    dw = torch.empty(o, i, 1, 1, device=x.device, dtype=x.dtype)
    if rows == 0:
        return dw.zero_()
    per, g = wgrad_partition(rows, p, q)
    part = torch.empty(g * p * q, device=x.device, dtype=torch.float32)
    _build.launch("ofa_pw_masked_wgrad_" + suffix, x.device, a, b, bound, part, dw, rows, p, q,
                  int(project), per, g)
    _count(pw_masked_wgrad, suffix)
    return dw


class _MaskedPointwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bound, side):
        ctx.save_for_backward(x, w, bound)
        ctx.side = side
        return pw_masked_forward(x, w, bound, side=side)

    @staticmethod
    def backward(ctx, dy):
        x, w, bound = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = pw_masked_dgrad(dy, w, bound, side=ctx.side)
        if ctx.needs_input_grad[1]:
            dw = pw_masked_wgrad(x, dy, bound, side=ctx.side)
        return dx, dw, None, None


def masked_pointwise(x, w, bound, *, side):
    """The masked 1x1 conv (module docstring), differentiable in x and w: its
    three directions through csrc/pw_masked.cu for CUDA tensors; for CPU
    ones the plain version and its autograd."""
    if x.device.type == "cpu":
        return masked_pointwise_reference(x, w, bound, side=side)
    _side(side)
    return _MaskedPointwise.apply(x, w, bound, side)


for _wrapper in (pw_masked_forward, pw_masked_dgrad, pw_masked_wgrad):
    _wrapper.launches = _wrapper.launches_bf16 = 0
