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
(`.launches`, `.launches_bf16`: one a call of either side, the wgrad's
finish included). A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version (`masked_pointwise_dgrad_reference` and
`masked_pointwise_wgrad_reference` for dx and dW, one product each) and
counts nothing. float32 (3xTF32) or bfloat16 activations and weights of
one type (bf16 results rounded once from float32 sums). Nothing reads `bound` on
the host, so a captured CUDA graph replays the same launches for every
subnet.

The kernel (csrc/pw_masked.cu) is persistent: a forward or dgrad launch
takes `gemm_grid` blocks over the 64-row tiles, each holding the
bank in shared memory and streaming its tiles through a TMA ring. The
wgrad sums over the rows with no atomics: CLUSTER-block clusters of runs
of rows add their tiles on chip, and with more than one cluster of runs a
second kernel adds the clusters' float32 partials (in a workspace this
module allocates) in order; its partition (`wgrad_partition`) comes from
the shapes alone, so two calls on the same inputs give the same bits on
any card. These plans and the shared memory a block takes (`smem_bytes`)
are mirrored here so that the CPU tests can hold them
(tests/test_torch_pw_masked_tiles.py) and chip_smoke.py phase 1 can hold
the mirror to the kernel's own sizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..elastic import channel_mask
from . import _build

KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SIDES = ("expand", "project")
# the kernel's tiling (csrc/pw_masked.cu): 64-row tiles (wgmma's M), N in
# chunks of BN columns, K in chunks of LINE bytes (one 128-byte-swizzled
# TMA box of 64 rows); every dimension but the rows a multiple of ALIGN_CH
# channels, every pointer 16-byte aligned
BM, BN, LINE = 64, 64, 128
ALIGN_CH = 8
# a forward / dgrad block's shape by (type, bounded on K), csrc/pw_masked.cu
# `Cfg`: consumer warpgroups, boxes in a warpgroup's ring, output through
# shared memory and TMA (else stored directly), copies of the bank
# (float32's held split into big and small for wgmma's operand)
GEMM_CFG = {(torch.bfloat16, False): dict(wgs=3, stages=4, staged=True, banks=1),
            (torch.bfloat16, True): dict(wgs=3, stages=4, staged=True, banks=1),
            (torch.float32, False): dict(wgs=2, stages=2, staged=False, banks=2),
            (torch.float32, True): dict(wgs=2, stages=8, staged=False, banks=1)}
GEMM_BLOCKS = 132         # persistent forward / dgrad blocks at most: one an H100 SM
CLUSTER = 8               # wgrad blocks adding their tiles through distributed shared memory
WGRAD_BLOCKS = 264        # wgrad blocks at most over the tiles: one wave, two an H100 SM
# rows a wgrad cluster of runs takes at least, by type: bf16's products are
# cheap and its blocks stream long runs best; float32's 3xTF32 wants more blocks
CLUSTER_ROWS = {torch.float32: 2048, torch.bfloat16: 18432}
WGRAD_STAGES = {torch.float32: 3, torch.bfloat16: 6}
PARTIAL_SHARE = 0.1       # the wgrad partials' traffic at most this share of the bf16 operands'
HEAD = ALIGN = 1024       # a block's mbarriers; the slack that aligns its buffers
SMEM_MAX = 232448         # an H100 block's shared memory


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


def chunk_k(dtype):
    """K a chunk: one 128-byte line of `dtype`."""
    return LINE * 8 // torch.finfo(dtype).bits


def smem_bytes(direction, dtype, k=None, n=None):
    """Dynamic shared memory of a block (bytes): a forward or dgrad bounded
    on N ("bound_n") or on K ("bound_k"), of a product with K `k` and N `n`,
    holds its warpgroups' rings, in bf16 their output staging (two 64 x 64
    chunks each) and a zero panel, all in 64-row x LINE panels, then its
    copies of the bank as [N rounded up to BN][K in chunks]; a wgrad
    ("wgrad") holds its ring of A and B boxes of 64 rows."""
    panel, ck = BM * LINE, chunk_k(dtype)
    if direction == "wgrad":
        return ALIGN + HEAD + WGRAD_STAGES[dtype] * 2 * (BM // ck) * panel
    cfg = GEMM_CFG[dtype, direction == "bound_k"]
    panels = cfg["wgs"] * (cfg["stages"] + (2 * (BN // ck) if cfg["staged"] else 0))
    panels += 1 if cfg["staged"] else 0
    bank = -(-n // BN) * BN * -(-k // ck) * LINE
    return ALIGN + HEAD + panels * panel + cfg["banks"] * bank


def gemm_supported(k, n, dtype, bound_k):
    """Whether the forward / dgrad kernel takes a product of K `k` and N `n`
    bounded on K (`bound_k`) or on N: its bank fits beside the rings, and a
    tile's K chunks fit in a warpgroup's ring where they are held across
    more than one N chunk."""
    return (smem_bytes("bound_k" if bound_k else "bound_n", dtype, k, n) <= SMEM_MAX
            and (n <= BN or -(-k // chunk_k(dtype)) <= GEMM_CFG[dtype, bound_k]["stages"]))


def gemm_grid(rows, dtype, bound_k):
    """(blocks, tiles a warpgroup walks at most) of a forward or dgrad over
    `rows` rows: a block a 64-row tile, at most GEMM_BLOCKS; from the
    shapes alone."""
    tiles = -(-rows // BM)
    blocks = max(1, min(tiles, GEMM_BLOCKS))
    return blocks, -(-(-(-tiles // blocks)) // GEMM_CFG[dtype, bound_k]["wgs"])


def tile_owner(tile, blocks, wgs):
    """(block, warpgroup) that computes 64-row tile `tile` of a launch of
    `blocks` blocks of `wgs` consumer warpgroups: block b walks tiles b, b +
    blocks, ..., its j-th going to warpgroup j % wgs."""
    return tile % blocks, tile // blocks % wgs


def wgrad_partition(rows, p, q, dtype):
    """(rows a block sums, clusters G along the rows) for a wgrad of [rows,
    p] by [rows, q] in `dtype`: CLUSTER * G runs of a multiple of BM rows
    cover the rows (the last runs may be empty), a cluster at least
    CLUSTER_ROWS[dtype] rows, at most WGRAD_BLOCKS blocks over the 64 x 64
    tiles (one wave), with G > 1 only where the float32 partials' traffic
    (G written and read back, p x q each) is at most PARTIAL_SHARE of the
    bf16 operands' bytes; from the shapes alone (the partials are added in
    this partition's order)."""
    tiles = -(-p // BM) * -(-q // BN)
    want = min(WGRAD_BLOCKS // (CLUSTER * tiles), rows // CLUSTER_ROWS[dtype])
    affordable = int(PARTIAL_SHARE * rows * (p + q) * 2 // (2 * 4 * p * q))
    g = max(1, min(want, affordable))
    runs = CLUSTER * g
    per = -(-(-(-rows // runs)) // BM) * BM
    return per, g


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
    """C [R, n] = a2 [R, K] . B^T through the gemm entry point (B = b2, or
    b2 transposed with `b_kn`)."""
    r, k = a2.shape
    if not gemm_supported(k, n, a2.dtype, bound_k):
        raise ValueError("the masked 1x1 kernel holds the bank in shared memory beside its "
                         "rings; K %d, N %d in %s (bounded on %s) do not fit"
                         % (k, n, a2.dtype, "K" if bound_k else "N"))
    c = torch.empty(r, n, device=a2.device, dtype=a2.dtype)
    _build.launch("ofa_pw_masked_gemm_" + suffix, a2.device, a2, b2, bound, c, r, k, n,
                  int(b_kn), int(bound_k), gemm_grid(r, a2.dtype, bound_k)[0])
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
    the kernel for CUDA tensors (and its finish where G > 1), in x's type;
    for CPU ones the plain version."""
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
    per, g = wgrad_partition(rows, p, q, x.dtype)
    part = torch.empty(g * p * q, device=x.device, dtype=torch.float32) if g > 1 else None
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
