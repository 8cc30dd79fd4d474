"""The expand lever (JAX's `expand_switch`) of the port against the JAX
package on the CPU: the six products of the plain masked 1x1
(`ops/kernels/pw_masked.py`, the contract of csrc/pw_masked.cu) against the
sliced product in float64; the masked forwards of the S4 and the X4 (both
modes) with the lever, and with the depthwise lever too, against JAX's
`apply` with `net.expand_switch = True` (its `lax.switch` over
`_sliced_mbconv_branch`) and against the port without the lever; one SGD
step of `SRTrainer(expand_switch=True)` against JAX's; the window step with
the lever against the same window without it; the lever's refusals and the
cases where it does nothing; and the wrappers counting no launch on CPU
tensors (the kernel itself is held to the plain version on the card by
`chip_smoke.py` phase 2).

Inputs come from numpy seeds; the port's weights cross into JAX through
`import_torch_s4` / `import_torch_x4` (tests/test_torch_scan_trainer.py's
`_twin`: random BN statistics, transform matrices off the identity), the
space is tests/test_expand_switch.py's `SMALL` (ks 3/5, e 2/3: middle
widths 16 and 24 at width 8). Tolerances:
- the six plain products against the sliced float64 product: max |diff|
  within 1e-6 of the tensor's largest magnitude (one float32 product of
  at most 24 terms, or 200 rows for the weight gradients, in another
  order: ~2^-24 a rounding, a few dozen roundings);
- whole masked forwards and running statistics, against JAX and against
  the port without the lever: tests/test_expand_switch.py's own, rtol /
  atol 1e-5 (the port's plain path gives the same bits without the lever
  where it slices nothing, and a float32 order apart where it does);
- one SGD step against JAX's: tests/test_expand_switch.py's, the loss
  within 1e-6 and the parameters rtol 1e-4 / atol 1e-5;
- the window steps with and without the lever: the same step tolerance
  (parameters and running statistics), the window's losses 1e-6;
- the refusals, the routes and the launch counts: exact.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, sample_subnet
from ofa_sr_tpu_torch.models import layers as tlayers
from ofa_sr_tpu_torch.models.layers import set_expand_lever
from ofa_sr_tpu_torch.ops.kernels import pw_masked as tpw
from ofa_sr_tpu_torch.train import SRTrainer
from test_torch_scan_trainer import _bridge, _jcfg, _port_net, _twin

NET_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# tests/test_expand_switch.py's SMALL: middle widths 16 and 24 at width 8
SMALL_KW = dict(ks_list=[3, 5], expand_list=[2, 3], depth_list=[1, 2],
                pixel_d_list=[1, 2], n_stages=2, width=8)
ONE_EXPAND_KW = dict(SMALL_KW, expand_list=[3])
BS, HR = 2, 16
# the port's levers against JAX's attributes (ofa_sr_tpu/train/train_step.py:91-119)
LEVERS = {"expand": dict(expand_switch=True),
          "expand + dw": dict(expand_switch=True, dw_switch=True)}
FORWARD_CASES = [("s4", "sr", True, "expand"), ("s4", "sr", True, "expand + dw"),
                 ("s4", "sr", False, "expand"), ("x4", "sr", True, "expand"),
                 ("x4", "autoencoder", True, "expand + dw")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX sides (most of this file's time is JAX compiling its
    branches), computed in threads from the first test that asks."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {"forwards": {c: pool.submit(_jax_forward, *c) for c in FORWARD_CASES},
               "step": pool.submit(_jax_step)}


def _set_jax_lever(jnet, expand_switch=False, dw_switch=False):
    jnet.expand_switch, jnet.dw_switch = expand_switch, dw_switch
    jnet.ks_switch, jnet.dw_opts = False, None


def _cfg_with_pixel_d(space, pd, n_trunks):
    return next(c for c in (sample_subnet(space, seed=s, n_trunks=n_trunks) for s in range(100))
                if c.pixel_d == pd and len(set(c.e)) > 1)


def _forward_inputs(kind, mode):
    space = SearchSpace(**SMALL_KW)
    cfg = _cfg_with_pixel_d(space, 2, 2 if kind == "x4" else 1)
    rng = np.random.RandomState(7)
    side = HR if mode == "autoencoder" else HR // 4
    return space, cfg, rng.rand(BS, side, side, 3).astype(np.float32)


# -- the six products of the plain version ---------------------------------------

def _sliced64(side, x, w, m, dy):
    """(y, dx, dW) of the sliced product in float64, padded with zeros: the
    expand's output channels below m, the project's input channels."""
    x, w, dy = (np.asarray(t, np.float64) for t in (x, w[:, :, 0, 0], dy))
    if side == "expand":
        y = np.zeros(x.shape[:-1] + (w.shape[0],))
        y[..., :m] = x @ w[:m].T
        dx = dy[..., :m] @ w[:m]
        dw = np.zeros(w.shape)
        dw[:m] = dy.reshape(-1, dy.shape[-1])[:, :m].T @ x.reshape(-1, x.shape[-1])
    else:
        y = x[..., :m] @ w[:, :m].T
        dx = np.zeros(x.shape)
        dx[..., :m] = dy @ w[:, :m]
        dw = np.zeros(w.shape)
        dw[:, :m] = dy.reshape(-1, dy.shape[-1]).T @ x.reshape(-1, x.shape[-1])[:, :m]
    return y, dx, dw[:, :, None, None]


def _scaled_close(got, ref, what, scaled=1e-6):
    got, ref = got.detach().numpy().astype(np.float64), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= scaled * max(1.0, float(np.abs(ref).max())), (what, err)


@pytest.mark.parametrize("side", tpw.SIDES)
@pytest.mark.parametrize("m", [0, 16, 20, 24])
def test_plain_products_match_sliced_float64(side, m):
    """The forward, dgrad and wgrad wrappers on CPU tensors (the plain
    version) and the autograd of `masked_pointwise` against the sliced
    product in float64, at the bank width 24 of SMALL's middle widths, on
    the grid (16), off it (20), at 0 and at the bank width; the values past
    the bound exactly 0."""
    rng = np.random.RandomState(m + (side == "project"))
    c_in, mid, c_out = 8, 24, 8
    rows = (2, 10, 10)
    if side == "expand":
        x, w = rng.randn(*rows, c_in), rng.randn(mid, c_in, 1, 1)
        dy = rng.randn(*rows, mid)
    else:
        x, w = rng.randn(*rows, mid), rng.randn(c_out, mid, 1, 1)
        dy = rng.randn(*rows, c_out)
    xt, wt, dyt = (torch.from_numpy(t.astype(np.float32)) for t in (x, w, dy))
    x, w, dy = (t.numpy() for t in (xt, wt, dyt))  # the float32 values, in float64 below
    bound = torch.tensor(m, dtype=torch.int32)
    y64, dx64, dw64 = _sliced64(side, x, w, m, dy)
    what = "%s m %d" % (side, m)
    y = tpw.pw_masked_forward(xt, wt, bound, side=side)
    dx = tpw.pw_masked_dgrad(dyt, wt, bound, side=side)
    dw = tpw.pw_masked_wgrad(xt, dyt, bound, side=side)
    _scaled_close(y, y64, what + " y")
    _scaled_close(dx, dx64, what + " dx")
    _scaled_close(dw, dw64, what + " dW")
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    tpw.masked_pointwise(xg, wg, bound, side=side).backward(dyt)
    assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)
    if side == "expand":
        assert not y[..., m:].any() and not dw[m:].any()
    else:
        assert not dx[..., m:].any() and not dw[:, m:].any()


# -- whole masked forwards ---------------------------------------------------------

def _jax_forward(kind, mode, training, lever):
    """JAX's `apply` with the lever on `_twin`'s weights: (y, state dict)."""
    space, cfg, x = _forward_inputs(kind, mode)
    jnet, p, s = _twin(kind, SMALL_KW, seed=1)
    _set_jax_lever(jnet, **LEVERS[lever])
    kw = {"mode": mode} if kind == "x4" else {}
    y, s1 = jax.jit(jnet.apply, static_argnames=("pixel_d", "training") + tuple(kw))(
        p, s, jnp.asarray(x), _jcfg(cfg).to_device(jnet.space), pixel_d=2, training=training,
        **kw)
    return np.asarray(y), _bridge(kind)(p, s1), (p, s)


@pytest.mark.parametrize("case", FORWARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_masked_forward_with_lever_matches_jax(jax_refs, case):
    """`forward_masked` at pixel_d 2 with the lever set by `SRTrainer` (and
    with the depthwise lever too), train-mode and eval-mode BN on the S4,
    both modes of the X4, against JAX's `apply` with `expand_switch` (and
    `dw_switch`, which JAX forwards as `ks_switch` inside its branches):
    outputs and running statistics; the same port net without any lever
    gives the same outputs and running statistics."""
    kind, mode, training, lever = case
    y_j, sd_j, (p, s) = jax_refs["forwards"][case].result()
    space, cfg, x = _forward_inputs(kind, mode)
    kw = {"mode": mode} if kind == "x4" else {}
    outs, states = [], []
    for kwargs in (LEVERS[lever], {}):
        net = _port_net(kind, p, s, SMALL_KW)
        SRTrainer(net, mode=mode, **kwargs)
        assert net.expand_lever is bool(kwargs)
        with torch.no_grad():
            outs.append(net.forward_masked(torch.from_numpy(x), cfg.to_device(space), cfg.d, 2,
                                           bn_training=training, **kw).numpy())
        states.append(net.state_dict())
    np.testing.assert_allclose(outs[0], y_j, err_msg=str(case), **NET_TOL)
    np.testing.assert_allclose(outs[0], outs[1], err_msg=str(case), **NET_TOL)
    for k, v in sd_j.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(states[0][k].numpy(), v.numpy(), err_msg=k, **NET_TOL)
            np.testing.assert_allclose(states[0][k].numpy(), states[1][k].numpy(), err_msg=k,
                                       **NET_TOL)


# -- one SGD step -------------------------------------------------------------------

def _step_inputs():
    """tests/test_expand_switch.py's batch (its seeds) and subnet."""
    batch = {"image": np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32),
             "x2": np.random.RandomState(2).rand(2, 8, 8, 3).astype(np.float32),
             "x4": np.random.RandomState(3).rand(2, 4, 4, 3).astype(np.float32)}
    return batch, sample_subnet(SearchSpace(**SMALL_KW), seed=5)


def _jax_step():
    """One SGD step of JAX's `SRTrainer(expand_switch=True)` on `_twin`'s
    weights: the loss and the state dict after it."""
    jnet, p, s = _twin("s4", SMALL_KW, seed=2)
    batch, cfg = _step_inputs()
    tr = JaxTrainer(jnet, opt_type="sgd", weight_decay=0.0, expand_switch=True)
    step = tr.make_train_step(n_subnets=1, donate=False)
    p1, s1, _, m = step(p, s, tr.init_opt_state(p), {k: jnp.asarray(v) for k, v in batch.items()},
                        (_jcfg(cfg).to_device(jnet.space),), jnp.asarray(1e-2))
    return dict(p=p, s=s, loss=float(m["loss"]), after=_bridge("s4")(p1, s1))


@pytest.mark.parametrize("path", ["train_step", "window"])
def test_sgd_step_with_lever_matches_jax(jax_refs, path):
    """One SGD step (lr 1e-2, no weight decay, tests/test_expand_switch.py's
    trainer and inputs) of `SRTrainer(expand_switch=True)` against JAX's:
    the eager `train_step` (the sliced form, where the lever changes
    nothing) and a window of one step of `make_scan_train_step` (the masked
    form, both 1x1 convs through `masked_pointwise`)."""
    ref = jax_refs["step"].result()
    batch, cfg = _step_inputs()
    net = _port_net("s4", ref["p"], ref["s"], SMALL_KW)
    tr = SRTrainer(net, opt_type="sgd", weight_decay=0.0, expand_switch=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if path == "train_step":
        loss = float(tr.train_step(tb, [cfg], 1e-2)["loss"])
    else:
        loss = float(tr.make_scan_train_step(1)([tb], [[cfg]], [1e-2])["loss"])
    assert abs(loss - ref["loss"]) < 1e-6
    sd = net.state_dict()
    for k, v in ref["after"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **STEP_TOL)


# -- the window step -----------------------------------------------------------------

WINDOW_KW = dict(SMALL_KW, n_stages=1)


@pytest.mark.parametrize("dw", [False, True], ids=["expand", "expand+dw"])
def test_window_with_lever_matches_window_without(dw):
    """Two windows of 2 steps (`steps_per_dispatch` 2) of Adam with weight
    decay and touched masks, one subnet a step, with the expand lever (and
    the depthwise lever too) against the same windows without either: the
    per-step losses, the parameters and the running statistics; the lever's
    1x1 convs take the plain version here (CPU tensors)."""
    space = SearchSpace(**WINDOW_KW)
    rng = np.random.RandomState(3)
    batches = [{k: torch.from_numpy(rng.rand(BS, HR // f, HR // f, 3).astype(np.float32))
                for k, f in (("image", 1), ("x2", 2), ("x4", 4))} for _ in range(4)]
    cfgs = [[sample_subnet(space, seed=i)] for i in range(4)]
    runs = []
    for kw in (dict(expand_switch=True, dw_switch=dw), {}):
        net = OFAMobileNetS4(space, device="cpu", generator=torch.Generator().manual_seed(4))
        tr = SRTrainer(net, opt_type="adam", weight_decay=3e-5, **kw)
        step = tr.make_scan_train_step(1)
        losses = []
        for i in (0, 2):
            losses += step(batches[i:i + 2], cfgs[i:i + 2], [1e-3] * 2)["losses"].tolist()
        runs.append((losses, net.state_dict()))
    (l1, sd1), (l0, sd0) = runs
    np.testing.assert_allclose(l1, l0, rtol=0, atol=1e-6)
    for k, v in sd0.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd1[k].numpy(), v.numpy(), err_msg=k, **STEP_TOL)


# -- the lever's rules -----------------------------------------------------------------

def test_lever_off_by_default_and_set_by_the_trainer():
    net = OFAMobileNetS4(SearchSpace(**SMALL_KW), device="cpu")
    assert net.expand_lever is False and net.dw_lever is False
    SRTrainer(net, expand_switch=True, ks_switch=True)
    assert net.expand_lever is True and net.dw_lever is True
    set_expand_lever(net)
    assert net.expand_lever is False


def _block_inputs(space_kw):
    net = OFAMobileNetS4(SearchSpace(**space_kw), device="cpu")
    block = net.dec_blocks[0].mobile_inverted_conv
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 6, 6, 8).astype(np.float32))
    mid = block.inverted_bottleneck.conv.weight.shape[0]
    return block, x, torch.tensor(1, dtype=torch.int32), torch.tensor(mid - 8, dtype=torch.int32)


@pytest.mark.parametrize("refused", ["out_ch", "spatial_mask"])
def test_lever_refused_with_out_ch_or_spatial_mask(refused):
    """JAX asserts against `expand_switch` with an output width or a
    spatial mask (ofa_sr_tpu/models/layers.py:165-171); the port raises,
    with one expand option too; without the lever both run."""
    for space_kw in (SMALL_KW, ONE_EXPAND_KW):
        block, x, kidx, mid = _block_inputs(space_kw)
        kw = {"out_ch": torch.tensor(8, dtype=torch.int32)} if refused == "out_ch" else {
            "spatial_mask": torch.ones(1, 6, 6, 1)}
        with torch.no_grad():
            block.forward_masked(x, kidx, mid, bn_training=True, **kw)
            with pytest.raises(ValueError):
                block.forward_masked(x, kidx, mid, bn_training=True, expand_lever=True, **kw)


def _spy(monkeypatch, calls):
    for name in ("masked_pointwise", "masked_pointwise_reference"):
        fn = getattr(tlayers, name)

        def run(x, w, bound, *, side, name=name, fn=fn):
            calls.append((name, side, int(bound)))
            return fn(x, w, bound, side=side)
        monkeypatch.setattr(tlayers, name, run)


def test_lever_route_follows_use_kernels(monkeypatch):
    """With the lever, `forward_masked` takes `masked_pointwise` (the kernel
    on a CUDA tensor) when `use_kernels` is on and the plain version when it
    is off, for the expand and then the project conv, bounded at the width
    either way, and the two agree with the lever-off block; without the
    lever it takes neither."""
    calls = []
    _spy(monkeypatch, calls)
    block, x, kidx, mid = _block_inputs(SMALL_KW)
    ys = {}
    for lever, use_kernels in ((True, True), (True, False), (False, True)):
        with torch.no_grad():
            ys[lever, use_kernels] = block.forward_masked(
                x, kidx, mid, bn_training=True, use_kernels=use_kernels, expand_lever=lever)
    m = int(mid)
    assert calls == [("masked_pointwise", "expand", m), ("masked_pointwise", "project", m),
                     ("masked_pointwise_reference", "expand", m),
                     ("masked_pointwise_reference", "project", m)]
    for y in (ys[True, False], ys[False, True]):
        np.testing.assert_allclose(ys[True, True].numpy(), y.numpy(), **NET_TOL)


def test_lever_does_nothing_with_one_expand_option(monkeypatch):
    """With one expand option (JAX: `len(space.expand_list) > 1`) the lever
    takes neither 1x1 route, and the block's outputs are the lever-off
    block's bits."""
    calls = []
    _spy(monkeypatch, calls)
    block, x, kidx, mid = _block_inputs(ONE_EXPAND_KW)
    with torch.no_grad():
        ys = [block.forward_masked(x, kidx, mid, bn_training=False, expand_lever=lever)
              for lever in (True, False)]
    assert calls == [] and torch.equal(ys[0], ys[1])


def test_wrappers_on_cpu_launch_nothing():
    """The three directions of both sides on CPU tensors take the plain
    version (one product for dx and one for dW) and count no launch, f32
    and bf16; the standalone dgrad and wgrad equal the autograd's."""
    wrappers = (tpw.pw_masked_forward, tpw.pw_masked_dgrad, tpw.pw_masked_wgrad)
    before = [(f.launches, f.launches_bf16) for f in wrappers]
    rng = np.random.RandomState(0)
    for dtype in (torch.float32, torch.bfloat16):
        for side, (c_in, c_out) in (("expand", (8, 24)), ("project", (24, 8))):
            x = torch.from_numpy(rng.randn(2, 5, 5, c_in).astype(np.float32)).to(dtype)
            w = torch.from_numpy(rng.randn(c_out, c_in, 1, 1).astype(np.float32)).to(dtype)
            dy = torch.from_numpy(rng.randn(2, 5, 5, c_out).astype(np.float32)).to(dtype)
            bound = torch.tensor(13, dtype=torch.int32)
            y = tpw.pw_masked_forward(x, w, bound, side=side)
            dx = tpw.pw_masked_dgrad(dy, w, bound, side=side)
            dw = tpw.pw_masked_wgrad(x, dy, bound, side=side)
            rx, rw = tpw.masked_pointwise_grads_reference(x, w, bound, dy, side=side)
            assert y.dtype is dtype and torch.equal(dx, rx) and torch.equal(dw, rw)
            xt = x.clone().requires_grad_()
            tpw.masked_pointwise(xt, w, bound, side=side).backward(dy)
            assert torch.equal(xt.grad, rx)
    after = [(f.launches, f.launches_bf16) for f in wrappers]
    assert after == before


def test_wgrad_partition_covers_the_rows_once():
    """The wgrad's partition (shapes alone): CLUSTER * G runs of a multiple
    of 64 rows covering every row once (the last runs may be empty), at most
    WGRAD_BLOCKS blocks over the 64 x 64 tiles unless G is 1, at the S4
    step's rows and a few ragged ones, in both types."""
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (1, 31, 1000, 9216, 36864, 147456):
            for p, q in ((384, 64), (72, 40)):
                per, g = tpw.wgrad_partition(rows, p, q, dtype)
                runs = tpw.CLUSTER * g
                assert per % tpw.BM == 0 and runs * per >= rows > (per - tpw.BM) * runs
                tiles = -(-p // tpw.BM) * -(-q // tpw.BN)
                assert runs * tiles <= tpw.WGRAD_BLOCKS or g == 1
