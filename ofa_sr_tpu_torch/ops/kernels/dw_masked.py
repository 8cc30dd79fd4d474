"""The masked depthwise convolution: the JAX package's depthwise levers
(`ks_switch`, `dw_switch`; `models.layers.set_depthwise_lever`) in the
masked MBConv of the graphed training step, as one hand-written CUDA
kernel family
(csrc/dw_masked.cu) that reads the sampled kernel size and the channel
bound from the device.

    masked_depthwise(x, w, ks_idx, bound, *, ks_list, stride) -> y

x: NHWC [N,H,W,C]; w: the selected max-size kernel [C,1,K,K] (the
masked step's `select_kernel(kernel_candidates(...), ks_idx)`); ks_idx: a
one-element int32 device tensor, the index into sorted(set(ks_list));
bound: a one-element int32 device tensor, the channels below it run (the
nets pass the sampled width `mid`). Padding K//2 per
side at stride 1 or 2, the masked step's. The contract is the plain
version, `masked_depthwise_reference`:

    depthwise_conv2d(x * cmask, w * tapmask) * cmask

with cmask = channel_mask(bound, C) and tapmask the centred k x k window of
k = ks_list[ks_idx]. Its autograd gives the kernel's dx and dW: dx over the
same taps and channels, 0 from the bound on; dW over the k x k centre taps
below the bound, 0 at every other tap and channel. On the step's path this
is the full-width conv's result exactly (JAX's exactness argument, pinned by
tests/test_dw_switch.py): a k x k kernel at pad k//2 equals the centred
K x K one at pad K//2, the masked BN writes 0 to the channels from `mid`
on, and the gradient reaches the selected candidate's transform chain
through `select_kernel`, as before.

`masked_depthwise` is a `torch.autograd.Function` whose three directions
are the kernel's entry points, each a public function with its own launch
counter: `dw_masked_forward`, `dw_masked_dgrad` and `dw_masked_wgrad`
(`.launches`, `.launches_bf16`: one a call, the wgrad's two launches
included). A CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version (its autograd for dx and dW) and counts nothing. float32
or bfloat16 activations and weights of one type (bf16 results rounded once
from float32 sums). Nothing reads `ks_idx` or `bound` on the host, so a
captured CUDA graph replays the same launches for every subnet.

The wgrad sums over N*Ho*Wo rows in two passes with no atomics (fixed
per-block partials into a workspace this module allocates, then a second
kernel adding them in order), its partition chosen from the shapes alone:
two calls on the same inputs give the same bits on any card.

The kernel's tiling is mirrored here (`parity_taps`, `launch_grid`,
`partition`, `smem_bytes`), so that the host-side numbers it is launched
with can be checked on the CPU (tests/test_torch_dw_masked_tiles.py) and
its shared memory against the kernel's own sizes on the card
(chip_smoke.py phase 1).
"""

from __future__ import annotations

import torch

from ..conv import depthwise_conv2d
from ..elastic import channel_mask
from . import _build

KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
STRIDES = (1, 2)
BANK_SIZES = (3, 5, 7)
# the kernel's tiling (csrc/dw_masked.cu): a block of WARPS warps takes a
# channel group of GROUP_BYTES a pixel (32 float32 or 64 bf16 channels, one
# or two a thread) and walks a run of tiles of output rows x TILE_W columns;
# a thread's strip is strip rows x STRIP columns. The stride-2 dgrad's tile
# is 2*DX_CLASS[0] x 2*DX_CLASS[1] pixels of dx, DX_CLASS a parity class,
# one class a warp in strips of one class row.
WARPS = 4
STRIP = 8
TILE_W = 16
GROUP_BYTES = 128
SMEM_HEAD = 128           # shared memory ahead of a block's buffers
CORR_ROWS = {1: (8, 2), 2: (2, 1)}    # forward, stride-1 dgrad: (tile rows, strip rows)
WGRAD_ROWS = {1: (8, 2), 2: (2, 1)}   # wgrad pass 1
DX_CLASS = (8, 16)
CORR_BLOCKS = 528         # forward / dgrad blocks aimed at, all groups: 2 waves of 2 an SM of 132
WGRAD_BLOCKS = 528        # wgrad pass-1 blocks aimed at
MIN_TILES = 2             # tiles a block walks at least (its two buffers)


def _ks_table(ks_list):
    ks = tuple(sorted(set(int(k) for k in ks_list)))
    if not 1 <= len(ks) <= 4 or any(k < 1 or k % 2 == 0 for k in ks):
        raise ValueError("the masked depthwise takes 1 to 4 odd kernel sizes; got %s"
                         % (ks_list,))
    return ks


def tap_mask(ks_idx, ks_list, bank_ks, device=None):
    """(K, K) 0/1 float32 mask of the centred k x k window, k =
    sorted(set(ks_list))[ks_idx], read on the device."""
    ks = torch.tensor(_ks_table(ks_list), device=device)
    k = ks[ks_idx.reshape(()).long() if isinstance(ks_idx, torch.Tensor) else ks_idx]
    r = torch.arange(bank_ks, device=device)
    off = (bank_ks - k) // 2
    line = (r >= off) & (r < off + k)
    return (line[:, None] & line[None, :]).float()


def masked_depthwise_reference(x, w, ks_idx, bound, *, ks_list, stride=1):
    """The plain version: depthwise_conv2d(x * cmask, w * tapmask) * cmask,
    in x's type (cuDNN's grouped conv on the card)."""
    c, k = x.shape[-1], w.shape[-1]
    tm = tap_mask(ks_idx, ks_list, k, x.device).to(w.dtype)
    cm = channel_mask(bound, c, x.dtype, x.device)
    return depthwise_conv2d(x * cm, w * tm, stride) * cm


def masked_depthwise_grads_reference(x, w, ks_idx, bound, dy, *, ks_list, stride=1):
    """(dx, dW) of the plain version for the output cotangent dy."""
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    with torch.enable_grad():
        y = masked_depthwise_reference(x, w, ks_idx, bound, ks_list=ks_list, stride=stride)
        return torch.autograd.grad(y, (x, w), dy)


def out_size(n, bank_ks, stride):
    """Output side of a side-n input at padding K//2."""
    return (n + 2 * (bank_ks // 2) - bank_ks) // stride + 1


def group_channels(dtype):
    """Channels of a group: GROUP_BYTES of a pixel."""
    return GROUP_BYTES * 8 // torch.finfo(dtype).bits


def launch_grid(direction, n, h, w, stride):
    """The tiles a launch over x [n, h, w, .] walks (direction "fwd",
    "dgrad" or "wgrad"): (images, rows, columns, tile rows, tile columns)
    of the grid, walked image by image, row of tiles by row."""
    if direction == "dgrad" and stride == 2:
        return n, h, w, 2 * DX_CLASS[0], 2 * DX_CLASS[1]
    if direction == "dgrad":
        return n, h, w, CORR_ROWS[1][0], TILE_W
    rows = (CORR_ROWS if direction == "fwd" else WGRAD_ROWS)[stride][0]
    return n, -(-h // stride), -(-w // stride), rows, TILE_W  # out_size at any odd bank


def partition(direction, n, h, w, c, stride, dtype):
    """(tiles a block walks, blocks G along them) for a launch over x
    [n, h, w, c]: about CORR_BLOCKS (WGRAD_BLOCKS) blocks over all channel
    groups, each walking at least MIN_TILES tiles; from the shapes alone
    (the wgrad's partials are added in this partition's order)."""
    images, rows, cols, tile_rows, tile_cols = launch_grid(direction, n, h, w, stride)
    tiles = images * -(-rows // tile_rows) * -(-cols // tile_cols)
    groups = -(-c // group_channels(dtype))
    blocks = WGRAD_BLOCKS if direction == "wgrad" else CORR_BLOCKS
    per = max(MIN_TILES, -(-tiles // max(1, -(-blocks // groups))))
    return per, -(-tiles // per)


def parity_taps(k, p):
    """A stride-2 dgrad parity class p (of a dx row or column) at kernel size
    k: (first tap i0, number of taps n, first dy offset base). dx row 2a+p
    reads dy rows a+base .. a+base+n-1 against the taps i0+2(n-1), ..., i0,
    in that order (csrc/dw_masked.cu par_i0, par_n, par_base)."""
    i0 = (p + k // 2) & 1
    n = (k - i0 + 1) // 2
    return i0, n, (p + k // 2 - i0) // 2 - n + 1


def smem_bytes(direction, bank_ks, stride, dtype):
    """Dynamic shared memory of a block (bytes), sized for k = bank_ks: a
    128-byte head (the buffers' barriers) and two buffers of a tile's staged
    pixels (the wgrad's: the x window and the dy tile), or the wgrad's end
    reduction where that is larger."""
    s, k = stride, bank_ks
    if direction == "dgrad" and s == 2:
        taps = [parity_taps(k, p) for p in (0, 1)]
        halo = (max(base + m - 1 for _, m, base in taps if m)
                - min(base for _, m, base in taps if m))
        return SMEM_HEAD + 2 * (DX_CLASS[0] + halo) * (DX_CLASS[1] + halo) * GROUP_BYTES
    th = (WGRAD_ROWS if direction == "wgrad" else CORR_ROWS)[s][0]
    stage = ((th - 1) * s + k) * ((TILE_W - 1) * s + k) * GROUP_BYTES
    if direction != "wgrad":
        return SMEM_HEAD + 2 * stage
    return SMEM_HEAD + max(2 * (stage + th * TILE_W * GROUP_BYTES),
                           WARPS * k * k * group_channels(dtype) * 4)


def _check(a, b, w, ks_idx, bound, ks_list, stride, bank_ks=None):
    """The launch operands' checks: a, b (x or dy) contiguous NHWC CUDA
    tensors of one kernel type (b may be None), w [C,1,K,K] of that type
    (or None: the wgrad, with `bank_ks`), ks_idx and bound one-element
    int32 tensors on the device. Returns (suffix, C, K, ks table)."""
    dtype = a.dtype
    if dtype not in KERNEL_DTYPES:
        raise ValueError("the masked depthwise kernel takes float32 or bfloat16; got %s"
                         % (dtype,))
    c = a.shape[-1]
    k = w.shape[-1] if w is not None else bank_ks
    if a.ndim != 4 or (w is not None and tuple(w.shape) != (c, 1, k, k)):
        raise ValueError("the masked depthwise takes NHWC [N,H,W,C] activations and a "
                         "[C,1,K,K] kernel; got %s %s" % (
                             tuple(a.shape), None if w is None else tuple(w.shape)))
    if k not in BANK_SIZES or stride not in STRIDES:
        raise ValueError("the masked depthwise kernel takes a bank of size %s at stride %s; "
                         "got K=%s, stride %s" % (BANK_SIZES, STRIDES, k, stride))
    ks = _ks_table(ks_list)
    if ks[-1] > k:
        raise ValueError("kernel sizes %s do not fit a %dx%d bank" % (ks, k, k))
    tensors = {"a": a} if b is None else {"a": a, "b": b}
    if w is not None:
        tensors["w"] = w
    _build.require_cuda(a.device, dtype, **tensors)
    ints = {"ks_idx": ks_idx, "bound": bound}
    for name, t in ints.items():
        if t.numel() != 1:
            raise ValueError("%s must be a one-element int32 tensor; got shape %s"
                             % (name, tuple(t.shape)))
    _build.require_cuda(a.device, torch.int32, **ints)
    return KERNEL_DTYPES[dtype], c, k, ks


def _ks_args(ks):
    return (len(ks),) + ks + (1,) * (4 - len(ks))


def _count(wrapper, suffix):
    wrapper.launches += 1
    if suffix == "bf16":
        wrapper.launches_bf16 += 1


def dw_masked_forward(x, w, ks_idx, bound, *, ks_list, stride=1):
    """y of the masked depthwise (module docstring): the kernel for a CUDA
    x, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return masked_depthwise_reference(x, w, ks_idx, bound, ks_list=ks_list, stride=stride)
    suffix, c, k, ks = _check(x, None, w, ks_idx, bound, ks_list, stride)
    n, h, wd, _ = x.shape
    ho, wo = out_size(h, k, stride), out_size(wd, k, stride)
    y = torch.empty(n, ho, wo, c, device=x.device, dtype=x.dtype)
    _build.launch("ofa_dw_masked_fwd_" + suffix, x.device, x, w, ks_idx, bound, y,
                  n, h, wd, c, ho, wo, k, stride, *_ks_args(ks),
                  *partition("fwd", n, h, wd, c, stride, x.dtype))
    _count(dw_masked_forward, suffix)
    return y


def dw_masked_dgrad(dy, w, ks_idx, bound, *, ks_list, stride=1, in_hw):
    """dx of the masked depthwise for the output cotangent dy, x of spatial
    size `in_hw`: the kernel for a CUDA dy; for a CPU one the plain
    version's autograd."""
    if dy.device.type == "cpu":
        x = torch.zeros(dy.shape[0], *in_hw, dy.shape[-1], dtype=dy.dtype)
        return masked_depthwise_grads_reference(x, w, ks_idx, bound, dy, ks_list=ks_list,
                                                stride=stride)[0]
    suffix, c, k, ks = _check(dy, None, w, ks_idx, bound, ks_list, stride)
    n, ho, wo, _ = dy.shape
    h, wd = in_hw
    if (out_size(h, k, stride), out_size(wd, k, stride)) != (ho, wo):
        raise ValueError("dy %s is not the output of an input of %s" % (tuple(dy.shape),
                                                                         tuple(in_hw)))
    dx = torch.empty(n, h, wd, c, device=dy.device, dtype=dy.dtype)
    _build.launch("ofa_dw_masked_dgrad_" + suffix, dy.device, dy, w, ks_idx, bound, dx,
                  n, h, wd, c, ho, wo, k, stride, *_ks_args(ks),
                  *partition("dgrad", n, h, wd, c, stride, dy.dtype))
    _count(dw_masked_dgrad, suffix)
    return dx


def dw_masked_wgrad(x, dy, ks_idx, bound, *, ks_list, stride=1, bank_ks):
    """dW [C,1,K,K] (K = `bank_ks`) of the masked depthwise for the output
    cotangent dy: the kernel's two passes for CUDA tensors, in x's type; for
    CPU ones the plain version's autograd."""
    if x.device.type == "cpu":
        w = torch.zeros(x.shape[-1], 1, bank_ks, bank_ks, dtype=x.dtype)
        return masked_depthwise_grads_reference(x, w, ks_idx, bound, dy, ks_list=ks_list,
                                                stride=stride)[1]
    suffix, c, k, ks = _check(x, dy, None, ks_idx, bound, ks_list, stride, bank_ks)
    n, h, wd, _ = x.shape
    ho, wo = out_size(h, k, stride), out_size(wd, k, stride)
    if tuple(dy.shape) != (n, ho, wo, c):
        raise ValueError("dy %s is not the output shape %s of x %s" % (
            tuple(dy.shape), (n, ho, wo, c), tuple(x.shape)))
    per, g = partition("wgrad", n, h, wd, c, stride, x.dtype)
    part = torch.empty(g * k * k * c, device=x.device, dtype=torch.float32)
    dw = torch.empty(c, 1, k, k, device=x.device, dtype=x.dtype)
    _build.launch("ofa_dw_masked_wgrad_" + suffix, x.device, x, dy, ks_idx, bound, part, dw,
                  n, h, wd, c, ho, wo, k, stride, *_ks_args(ks), per, g)
    _count(dw_masked_wgrad, suffix)
    return dw


class _MaskedDepthwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ks_idx, bound, ks_list, stride):
        ctx.save_for_backward(x, w, ks_idx, bound)
        ctx.ks_list, ctx.stride = ks_list, stride
        return dw_masked_forward(x, w, ks_idx, bound, ks_list=ks_list, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, w, ks_idx, bound = ctx.saved_tensors
        dy = dy.contiguous()
        kw = dict(ks_list=ctx.ks_list, stride=ctx.stride)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dw_masked_dgrad(dy, w, ks_idx, bound, in_hw=tuple(x.shape[1:3]), **kw)
        if ctx.needs_input_grad[1]:
            dw = dw_masked_wgrad(x, dy, ks_idx, bound, bank_ks=w.shape[-1], **kw)
        return dx, dw, None, None, None, None


def masked_depthwise(x, w, ks_idx, bound, *, ks_list, stride=1):
    """The masked depthwise (module docstring), differentiable in x and w:
    its three directions through csrc/dw_masked.cu for CUDA tensors; for CPU
    ones the plain version and its autograd."""
    if x.device.type == "cpu":
        return masked_depthwise_reference(x, w, ks_idx, bound, ks_list=ks_list, stride=stride)
    return _MaskedDepthwise.apply(x, w, ks_idx, bound, _ks_table(ks_list), stride)


for _wrapper in (dw_masked_forward, dw_masked_dgrad, dw_masked_wgrad):
    _wrapper.launches = _wrapper.launches_bf16 = 0
