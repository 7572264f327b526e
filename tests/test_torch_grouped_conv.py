"""The port's grouped conv1d (autograd function over the Hopper kernels'
plain versions on the CPU) against the JAX Pallas kernel in interpret mode
and XLA's grouped conv: values, dX and dW, f32. Also the launch plans and
the weight layouts of the bf16 tensor-core forward, dX and dW kernels, which
run only on the card.

Tolerances are the JAX file's own (tests/test_pallas_conv.py): rtol/atol
1e-5 on values, rtol 1e-4 / atol 1e-5 on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch.ops import grouped_conv as gc
from ste_gan_tpu.ops.pallas_conv import grouped_conv1d, lax_grouped_conv1d

CASES = [
    # (B, T, Cin, Cout, K, stride, pad, groups) — as tests/test_pallas_conv.py
    (2, 64, 16, 32, 15, 1, 7, 1),
    (2, 64, 32, 64, 9, 2, 4, 4),
    (2, 64, 32, 64, 9, 2, 4, 16),
    (2, 64, 32, 64, 9, 4, 4, 8),
    (1, 50, 16, 16, 5, 2, 2, 4),
    (2, 64, 32, 256, 5, 1, 2, 2),
]


def _inputs(case, seed=0):
    b, t, cin, cout, k, stride, pad, groups = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin // groups, cout)) * 0.1).astype(np.float32)
    tgt = rng.normal(size=(b,)).astype(np.float32)
    return x, w, tgt


def _to_port(x, w):
    """JAX [B,T,C] / [K,cg,Cout] -> port [B,C,T] / [Cout,cg,K]."""
    return (torch.from_numpy(x.transpose(0, 2, 1).copy()),
            torch.from_numpy(w.transpose(2, 1, 0).copy()))


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_pallas_and_lax(case):
    b, t, cin, cout, k, stride, pad, groups = case
    x, w, _ = _inputs(case)
    xt, wt = _to_port(x, w)
    got = gc.grouped_conv1d(xt, wt, stride=stride, padding=(pad, pad),
                            groups=groups).numpy().transpose(0, 2, 1)
    kw = dict(stride=stride, padding=(pad, pad), groups=groups)
    pallas = grouped_conv1d(jnp.asarray(x), jnp.asarray(w), interpret=True,
                            **kw)
    lax = lax_grouped_conv1d(jnp.asarray(x), jnp.asarray(w), **kw)
    assert got.shape == pallas.shape
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(lax), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES[:5])
def test_gradients_match_pallas(case):
    b, t, cin, cout, k, stride, pad, groups = case
    x, w, tgt = _inputs(case)
    kw = dict(stride=stride, padding=(pad, pad), groups=groups)

    def loss(x_, w_):
        y = grouped_conv1d(x_, w_, None, interpret=True, **kw)
        return jnp.sum(jnp.square(jnp.mean(y, axis=(1, 2)) - tgt))

    want_l, (want_dx, want_dw) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    xt, wt = _to_port(x, w)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    y = gc.grouped_conv1d(xt, wt, **kw)
    got_l = torch.sum(torch.square(y.mean(dim=(1, 2)) - torch.from_numpy(tgt)))
    got_l.backward()

    np.testing.assert_allclose(float(got_l.detach()), float(want_l),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1),
                               np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 1, 0),
                               np.asarray(want_dw), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_backward_pieces_match_autograd_of_plain_conv(case):
    """The polyphase dX and the per-tap dW equal torch autograd of the
    plain forward (rtol 1e-4 / atol 1e-5, f32)."""
    b, t, cin, cout, k, stride, pad, groups = case
    x, w, _ = _inputs(case, seed=1)
    xt, wt = _to_port(x, w)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    y = gc.conv_fwd_plain(xt, wt, stride, pad, pad, groups)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    want_dx, want_dw = torch.autograd.grad(y, (xt, wt), dy)
    got_dx = gc.conv_dx(dy, wt.detach(), stride, pad, t, groups)
    got_dw = gc.conv_dw(xt.detach(), dy, k, stride, pad, pad, groups)
    np.testing.assert_allclose(got_dx.numpy(), want_dx.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_dw.numpy(), want_dw.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_weight_gradient_skipped_when_weight_is_frozen(monkeypatch):
    """In the generator phase the discriminator's weights need no
    gradient: the backward computes dX only."""
    x, w, _ = _inputs(CASES[1])
    xt, wt = _to_port(x, w)
    xt.requires_grad_(True)
    called = []
    monkeypatch.setattr(gc, "conv_dw",
                        lambda *a, **kw: called.append(1))
    y = gc.grouped_conv1d(xt, wt, stride=2, padding=(4, 4), groups=4)
    y.sum().backward()
    assert xt.grad is not None and not called


def test_bf16_operands_return_bf16():
    x, w, _ = _inputs(CASES[1])
    xt, wt = _to_port(x, w)
    got = gc.grouped_conv1d(xt.bfloat16(), wt.bfloat16(), stride=2,
                            padding=(4, 4), groups=4)
    want = gc.grouped_conv1d(xt, wt, stride=2, padding=(4, 4), groups=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=0.05, atol=0.05)


def test_other_devices_raise_instead_of_falling_back():
    x = torch.zeros(1, 8, 16, device="meta")
    w = torch.zeros(8, 2, 3, device="meta")
    with pytest.raises(RuntimeError):
        gc.conv_fwd(x, w, 1, 1, 1, 4)


def test_gradient_wrappers_reject_shapes_that_do_not_fit():
    """The kernels index by the shapes they are given: dy's channels must
    match the weight, and x and dy their batch and the groups."""
    w = torch.zeros(8, 2, 3)
    with pytest.raises(ValueError):
        gc.conv_dx(torch.zeros(1, 6, 10), w, 2, 1, 20, 4)
    with pytest.raises(ValueError):
        gc.conv_dw(torch.zeros(2, 8, 20), torch.zeros(1, 8, 10), 3, 2, 1, 1,
                   4)
    with pytest.raises(ValueError):
        gc.conv_dw(torch.zeros(1, 6, 20), torch.zeros(1, 8, 10), 3, 2, 1, 1,
                   4)


DX_CASES = [
    # (stride, K, pad_l, pad_r, T, groups)
    (2, 9, 4, 4, 64, 4),
    (4, 9, 4, 4, 64, 8),      # stride 4
    (2, 5, 2, 2, 51, 4),      # odd T
    (3, 7, 3, 1, 50, 2),      # the last 2 inputs are dropped
    (4, 3, 1, 2, 33, 2),      # K < stride: a phase without taps
    (2, 37, 18, 18, 96, 16),  # the main path's layer 2, narrow
    (1, 5, 0, 4, 40, 1),
    (2, 4, 3, 0, 30, 2),      # even K, uneven pads
]


@pytest.mark.parametrize("case", DX_CASES)
def test_polyphase_dx_matches_pallas_and_dilate_flip(case):
    """The polyphase ``conv_dx_plain`` against JAX's gradient through the
    Pallas kernel (interpret mode) and against the dilate-and-flip
    formulation, f32, rtol 1e-4 / atol 1e-5."""
    stride, k, pad_l, pad_r, t, groups = case
    b, cin, cout = 2, 3 * groups, 5 * groups
    t_out = gc.out_length(t, k, stride, pad_l, pad_r)
    rng = np.random.default_rng(sum(case))
    x = rng.normal(size=(b, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin // groups, cout)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(b, t_out, cout)).astype(np.float32)

    _, vjp = jax.vjp(
        lambda x_: grouped_conv1d(x_, jnp.asarray(w), stride=stride,
                                  padding=(pad_l, pad_r), groups=groups,
                                  interpret=True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0]).transpose(0, 2, 1)

    dyt = torch.from_numpy(dy.transpose(0, 2, 1).copy())
    wt = torch.from_numpy(w.transpose(2, 1, 0).copy())
    got = gc.conv_dx_plain(dyt, wt, stride, pad_l, t, groups)
    dy_dil, w_t, pl, pr = gc.dilate_flip(dyt, wt, stride, pad_l, t, groups)
    flip = gc.conv_fwd_plain(dy_dil, w_t, 1, pl, pr, groups)
    assert got.shape == (b, cin, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), flip.numpy(), rtol=1e-4,
                               atol=1e-5)


#: (B, T, Cin, Cout, K, stride, pad, groups): the six main-path geometries
#: (small scale discriminators' grouped layers, 2B = 64, three scales), the
#: CASES above, K < stride, and the full scale discriminators' grouped
#: layers (``FULL_SCALE_SPEC``, K 41; 2B = 64, three scales).
FULL_SCALE_GROUPED = ((2048, 128, 128, 41, 2, 20, 4),
                      (1024, 128, 256, 41, 2, 20, 16),
                      (512, 256, 512, 41, 4, 20, 16),
                      (128, 512, 1024, 41, 4, 20, 16),
                      (32, 1024, 1024, 41, 1, 20, 16))
K_BELOW_STRIDE = (2, 33, 8, 16, 3, 4, 1, 2)
PLAN_CASES = (
    [(64, 2048 >> s, 128, 256, 37, 2, 18, 4) for s in range(3)]
    + [(64, 1024 >> s, 256, 512, 37, 2, 18, 16) for s in range(3)]
    + CASES + [K_BELOW_STRIDE]
    + [(64, t >> s, *rest) for t, *rest in FULL_SCALE_GROUPED
       for s in range(3)])


@pytest.mark.parametrize("case", PLAN_CASES)
def test_launch_plans_cover_the_work_once(case):
    """``_plan_dx`` / ``_plan_dw`` fit shared memory, and split the work so
    that every piece is done exactly once: dX by (time tile, group, channel
    tile, batch row) blocks, (phase, rows) warp units and (o-chunk, taps)
    weight stages; dW by (tap tile, group x channel tiles) blocks per chunk
    and row chunks that cover every (batch row, time step) once."""
    b, t, cin, cout, k, stride, pad, groups = case
    t_out = gc.out_length(t, k, stride, pad, pad)
    cg, og = cin // groups, cout // groups

    px = gc._plan_dx(b, cin, cout, k, stride, pad, t, t_out, groups)
    assert px.smem <= 227 * 1024
    # Blocks: time tiles cover [0, T), (group, channel tile) cover every
    # input channel, z every batch row.
    gx, gy, gz = px.grid
    assert gz == b and gx * px.stride * px.bq >= t > (gx - 1) * px.stride * px.bq
    chans = [g * cg + ct * px.nb + c for g in range(groups)
             for ct in range(px.n_ctiles) for c in range(px.nb)
             if ct * px.nb + c < cg]
    assert sorted(chans) == list(range(cin)) and gy == groups * px.n_ctiles
    # Warp units: each (phase, row) of the tile exactly once.
    rows = [(r, q0 + q) for _, r, q0 in px.units() for q in range(px.wm)]
    assert sorted(rows) == [(r, q) for r in range(stride)
                            for q in range(px.bq)]
    # Weight stages: each (output channel, tap) of each phase exactly once;
    # each stage's taps fit the ring and the window holds their dy rows.
    seen = []
    for oc0, taps in px.tap_chunks():
        assert len(taps) <= px.mt
        for r, (j0, n, d) in enumerate(gc.phases(k, stride, pad)):
            seen += [(r, j0 + stride * m, o) for m in taps if m < n
                     for o in range(oc0, min(og, oc0 + px.oc))]
            for m in (m for m in taps if m < n):
                lo = d - px.dmin + px.nmax - 1 - m
                assert 0 <= lo and lo + px.bq <= px.win_rows
    want = [(r, j0 + stride * m, o)
            for r, (j0, n, _) in enumerate(gc.phases(k, stride, pad))
            for m in range(n) for o in range(og)]
    assert sorted(seen) == sorted(want)
    assert sorted(j for _, j, o in want if o == 0) == list(range(k))

    pw = gc._plan_dw(b, cin, cout, k, stride, pad, t, t_out, groups)
    assert pw.smem <= 227 * 1024
    gx, gy, gz = pw.grid
    cells = [(g, o, c, j) for bx in range(gx) for by in range(gy)
             for g, os_, cs, js in [pw.block(bx, by)]
             for o in os_ for c in cs for j in js]
    assert sorted(cells) == [(g, o, c, j) for g in range(groups)
                             for o in range(og) for c in range(cg)
                             for j in range(k)]
    tiles = [tl for ch in range(gz) for tl in pw.row_tiles(ch)]
    assert tiles == list(range(pw.n_rtiles))
    assert all(pw.row_tiles(ch) for ch in range(gz))
    rows = [row for tl in tiles for row in pw.rows(tl)]
    assert rows == [(bb, u) for bb in range(b) for u in range(t_out)]


@pytest.mark.parametrize("case", [PLAN_CASES[3], CASES[2], CASES[5],
                                  K_BELOW_STRIDE])
def test_dx_weight_layout(case):
    """``_dx_weights`` puts ``w[g*og + o, c, j0 + s*m]`` at
    ``[g, c // nb, r, m, c % nb, o]`` and zeros everywhere else."""
    b, t, cin, cout, k, stride, pad, groups = case
    plan = gc._plan_dx(b, cin, cout, k, stride, pad, t,
                       gc.out_length(t, k, stride, pad, pad), groups)
    w = torch.randn(cout, cin // groups, k, generator=torch.Generator()
                    .manual_seed(0))
    got = gc._dx_weights(w, plan).view(
        groups, plan.n_ctiles, stride, plan.nmax, plan.nb, plan.og_pad)
    want = torch.zeros_like(got)
    for r, (j0, n, _) in enumerate(gc.phases(k, stride, pad)):
        for m in range(n):
            for c in range(plan.cg):
                want[:, c // plan.nb, r, m, c % plan.nb, :plan.og] = (
                    w[:, c, j0 + stride * m].view(groups, plan.og))
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_forward_plan_covers_the_work_once(case):
    """``_plan_fwd`` fits shared memory; its (time tile, group x channel
    tile, batch row) blocks cover every output once; its (c-chunk, taps)
    weight stages cover every (input channel, tap) of the reduction once;
    and each tap's window rows lie inside the staged window and read
    ``x[u*s + j - pad_l]``."""
    b, t, cin, cout, k, stride, pad, groups = case
    t_out = gc.out_length(t, k, stride, pad, pad)
    cg, og = cin // groups, cout // groups

    p = gc._plan_fwd(b, cin, cout, k, stride, pad, t, t_out, groups)
    assert p.smem <= 227 * 1024
    gx, gy, gz = p.grid
    assert gz == b and gy == groups * p.n_otiles
    # Blocks do the same for every batch row: each (output channel, time
    # step) once.
    seen = np.zeros((cout, t_out), np.int64)
    for bx in range(gx):
        for by in range(gy):
            g, os_, us = p.block(bx, by)
            if len(os_) and len(us):
                seen[g * og + os_.start:g * og + os_.stop,
                     us.start:us.stop] += 1
    assert (seen == 1).all()
    # Weight stages: each (input channel, tap) once, within the ring.
    staged = np.zeros((cg, k), np.int64)
    for c0, taps in p.tap_chunks():
        assert len(taps) <= p.mt and c0 < p.cg_pad
        staged[c0:min(cg, c0 + p.cc), taps.start:taps.stop] += 1
        for j in taps:
            plane, row = p.tap_rows(j)
            # window position plane + s*(row + i) is x[(u0 + i)*s + j - pad_l]
            assert plane + stride * row == j and 0 <= plane < stride
            assert 0 <= row and row + p.bm <= p.V
    assert (staged == 1).all()


@pytest.mark.parametrize("case", [PLAN_CASES[3], CASES[2], CASES[5],
                                  K_BELOW_STRIDE])
def test_fwd_weight_layout(case):
    """``_fwd_weights`` puts ``w[g*og + o, c, j]`` at
    ``[g, o // ob, j, o % ob, c]`` and zeros everywhere else."""
    b, t, cin, cout, k, stride, pad, groups = case
    plan = gc._plan_fwd(b, cin, cout, k, stride, pad, t,
                        gc.out_length(t, k, stride, pad, pad), groups)
    w = torch.randn(cout, cin // groups, k, generator=torch.Generator()
                    .manual_seed(0))
    got = gc._fwd_weights(w, plan).view(
        groups, plan.n_otiles, k, plan.ob, plan.cg_pad)
    want = torch.zeros_like(got)
    wg = w.view(groups, plan.og, plan.cg, k)
    for o in range(plan.og):
        want[:, o // plan.ob, :, o % plan.ob, :plan.cg] = (
            wg[:, o].transpose(1, 2))
    assert torch.equal(got, want)
