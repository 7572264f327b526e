"""The port's grouped conv1d (autograd function over the Hopper kernels'
plain versions on the CPU) against the JAX Pallas kernel in interpret mode
and XLA's grouped conv: values, dX and dW, f32. Also the launch plans and
the weight layouts of the bf16 tensor-core forward, dX and dW kernels, which
run only on the card, and the wgmma kernels' schedules emulated on the CPU
(``emulate_conv``, ``emulate_dw``) against the plain versions (1e-5
relative, f32); the dW kernel's MN-major descriptor reads against x itself
(exact).

Tolerances are the JAX file's own (tests/test_pallas_conv.py): rtol/atol
1e-5 on values, rtol 1e-4 / atol 1e-5 on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


@pytest.fixture
def one_thread():
    """The emulators' many small products run fastest on one thread; with
    several test workers, each with a thread per core, they stall each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
#: Clusters of 1 .. 8 CTAs of the dW kernel an H100 80GB HBM3 holds at once
#: (``cudaOccupancyMaxActiveClusters`` on the card, ``_cluster_table``).
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
#: The same for a made-up card of 20 SMs in two GPCs of 10, so that the
#: plans take other cluster sizes than on an H100.
SMALL_CLUSTERS = (20, 10, 6, 4, 4, 2, 2, 2)
CLUSTER_TABLES = pytest.mark.parametrize(
    "clusters", [H100_CLUSTERS, SMALL_CLUSTERS], ids=["h100", "20-sms"])
PLAN_CASES = (
    [(64, 2048 >> s, 128, 256, 37, 2, 18, 4) for s in range(3)]
    + [(64, 1024 >> s, 256, 512, 37, 2, 18, 16) for s in range(3)]
    + CASES + [K_BELOW_STRIDE]
    + [(64, t >> s, *rest) for t, *rest in FULL_SCALE_GROUPED
       for s in range(3)])


def _tile_coverage(plan):
    """Checks that the CTAs split the tiles into contiguous ranges, the two
    pipes of a CTA alternate and differ by at most one tile, and returns
    counts of the (batch row, group, channel tile, destination time) that
    the tiles write."""
    ranges = [plan.cta_tiles(c) for c in range(plan.grid)]
    assert [t for r in ranges for t in r] == list(range(plan.n_tiles))
    assert plan.grid <= 132 and all(len(r) for r in ranges)
    for c, r in enumerate(ranges):
        p0, p1 = plan.pipe_tiles(c, 0), plan.pipe_tiles(c, 1)
        assert sorted([*p0, *p1]) == list(r) and 0 <= len(p0) - len(p1) <= 1
    seen = np.zeros((plan.B, plan.G, plan.n_nt, plan.T_dst), np.int64)
    for i in range(plan.n_tiles):
        g, nt, b, tt = plan.tile(i)
        bb, chans, times = plan.outputs(i)
        assert bb == b and len(chans) and len(times)
        assert chans.start == g * plan.CO_total + nt * plan.CO
        seen[b, g, nt, times.start:times.stop] += 1
    # The channel tiles of a group cover its destination channels once.
    per_group = [c for nt in range(plan.n_nt)
                 for c in range(nt * plan.CO,
                                min(plan.CO_total, (nt + 1) * plan.CO))]
    assert per_group == list(range(plan.CO_total))
    return seen


def _check_smem(plan):
    """The slab (resident) or the four-slot chunk ring (streamed), the four
    window slots and the mbarriers fit one block's shared memory; a slot
    holds the window and the output tile."""
    assert plan.smem <= 227 * 1024
    w_bytes = (plan.KE if plan.resident else 4 * plan.ck) * plan.tap_bytes
    assert plan.win_off >= plan.w_off + w_bytes and plan.w_off >= 20 * 8
    assert plan.smem == plan.win_off + 4 * plan.slot_bytes
    assert plan.slot_bytes >= 2 * plan.S * plan.V * plan.C8 * 8
    assert plan.slot_bytes >= 2 * plan.CO * plan.out_ld
    assert plan.out_ld >= plan.R * plan.bm and plan.out_ld % 8 == 0
    assert plan.nt_w in (16, 32, 64) and plan.R * plan.CO <= plan.nt_w
    assert plan.C8 % 2 == 0 and plan.C8 * 8 >= plan.CR
    # Chunks: every tap once, in order, each within a ring slot.
    taps = [t for ch in plan.chunks() for t in ch]
    assert taps == list(range(plan.KE))
    assert all(len(ch) <= plan.ck for ch in plan.chunks())
    assert plan.resident == (plan.n_chunks == 1 and plan.ck == plan.KE) \
        or not plan.resident
    # Each tap's rows, shifted by the tile's rows, lie inside the window.
    for t in range(plan.KE):
        plane, row = plan.tap_rows(t)
        assert plane + plan.S * row == t and 0 <= plane < plan.S
        assert 0 <= row and row + plan.bm <= plan.V


@pytest.mark.parametrize("case", PLAN_CASES)
def test_launch_plans_cover_the_work_once(case):
    """``_plan_conv`` for dX and ``_plan_dw`` fit shared memory and split
    the work so that every piece is done exactly once: dX by tiles of
    (channel tile, batch row, time tile) over contiguous CTA ranges and two
    pipes, each (batch row, input position) of each channel tile once;
    every (phase, tap) in one column and one dy offset that the window
    holds; dW by cluster tiles and ranks (:func:`_check_dw_plan`), planned
    for the clusters an H100 and a small card hold at once."""
    b, t, cin, cout, k, stride, pad, groups = case
    t_out = gc.out_length(t, k, stride, pad, pad)
    cg, og = cin // groups, cout // groups

    px = gc._plan_conv(True, b, cin, cout, k, stride, pad, t, t_out, groups)
    _check_smem(px)
    assert (px.S, px.R, px.CR, px.CO_total) == (1, stride, og, cg)
    assert (px.C_src, px.T_src, px.C_dst, px.T_dst) == (cout, t_out, cin, t)
    assert px.n_tt == gc._cdiv(gc._cdiv(t, stride), px.bm)
    assert (_tile_coverage(px) == 1).all()
    # Phase r's tap j0 + s*m reads dy[q + d - m]: offset index
    # d - m - t_off in [0, KE), and the layout's tap P0 + r - s*index is j.
    slots = []
    for r, (j0, n, d) in enumerate(gc.phases(k, stride, pad)):
        for m in range(n):
            e = d - m - px.t_off
            assert 0 <= e < px.KE
            assert px.P0 + r - stride * e == j0 + stride * m
            slots.append((r, j0 + stride * m))
    assert sorted(j for _, j in slots) == list(range(k))
    assert len(set(slots)) == len(slots)

    for clusters in (H100_CLUSTERS, SMALL_CLUSTERS):
        _check_dw_plan(gc._plan_dw(b, cin, cout, k, stride, pad, t, t_out,
                                   groups, clusters))


def _check_dw_plan(pw):
    """``conv_dw_wgmma_kernel``'s plan: every (g, o, c, j) lies in exactly
    one cluster tile; every (batch row, u) in exactly one rank of each
    cluster; the reduce slices of the ranks partition the tile's (o, c)
    rows; the ring, raw buffers and reduce buffer fit shared memory."""
    b, groups, og, cg, k = pw.B, pw.G, pw.og, pw.cg, pw.K
    assert 1 <= pw.C <= 8 and pw.grid == pw.n_tiles * pw.C
    assert pw.n_tiles == groups * pw.n_ot * pw.n_ct * pw.n_parts
    cells = []
    for i in range(pw.n_tiles):
        g, ot, ct, part = pw.tile(i)
        n_o, n_c = pw.extent(i)
        cells += [(g, 64 * ot + o, pw.CO * ct + c, j) for o in range(n_o)
                  for c in range(n_c) for j in pw.taps(part)]
        slices = [pw.reduce_slice(i, r) for r in range(pw.C)]
        assert [x for sl in slices for x in sl] == list(range(n_o * n_c))
    assert sorted(cells) == [(g, o, c, j) for g in range(groups)
                             for o in range(og) for c in range(cg)
                             for j in range(k)]
    ranks = [pw.rank_rows(r) for r in range(pw.C)]
    assert [rt for rr in ranks for rt in rr] == list(range(pw.n_rt))
    rows = [(bb, u) for rr in ranks for rt in rr
            for bb, times in [pw.rows(rt)] for u in times]
    assert rows == [(bb, u) for bb in range(b) for u in range(pw.Tout)]
    # The parts split the units evenly, each warpgroup holds at most UW of
    # them; every unit's columns are its taps, and its rows lie in the
    # window.
    parts = [pw.part_units(part) for part in range(pw.n_parts)]
    assert [q for qs in parts for q in qs] == list(range(pw.U))
    assert max(map(len, parts)) - min(map(len, parts)) <= 1
    for part in range(pw.n_parts):
        real = list(pw.units(part, 0)) + list(pw.units(part, 1))
        assert real == list(parts[part])
        assert all(len(pw.units(part, wg)) <= pw.UW for wg in (0, 1))
        for q in real:
            start = pw.unit_start(part, q)
            plane, row = divmod(start, pw.C8 * pw.V)
            assert plane % pw.R == 0 and row + pw.BT <= pw.V
        taps = [j for q in real for r in range(pw.R)
                for j in [(q // pw.n_pg) * pw.stride + (q % pw.n_pg) * pw.R + r]
                if (q % pw.n_pg) * pw.R + r < pw.stride and j < k]
        assert taps == list(pw.taps(part))
        assert all(0 <= j - pw.first_row(part) * pw.stride < pw.JP
                   for j in taps)
    assert pw.R * pw.CO <= pw.nt_w in (16, 32, 64)
    assert pw.UW == gc._DW_UNITS[pw.nt_w]
    assert pw.smem <= 227 * 1024 and 2 <= pw.n_slots <= 4
    assert pw.slot_bytes >= 64 * pw.dy_pitch * 2 + pw.planes * pw.C8 * pw.V * 16
    assert pw.win_off == 64 * pw.dy_pitch * 2 and pw.dy_pitch >= pw.BT + 8
    assert pw.raw_off == pw.n_slots * pw.slot_bytes
    assert pw.smem >= 256 + pw.raw_off + 2 * pw.CO * pw.raw_pitch * 2
    assert pw.smem >= 256 + 64 * pw.CO * pw.JP * 4
    assert pw.raw_pitch >= 8 * pw.n_x8 and pw.raw_pitch % 64 == 8
    # The raw chunks from t0 rounded down to 8 cover the window.
    assert all(8 * pw.n_x8 >= pw.stride * pw.V + t0 % 8 for t0 in range(8))
    assert (pw.b_lbo, pw.b_sbo) == (8, pw.V)


def _layout_ids(plan, shape):
    """The layout of a weight whose elements are their own flat index + 1
    (f64, exact), and the count of each index in it."""
    ids = torch.arange(1, int(np.prod(shape)) + 1, dtype=torch.float64)
    got = gc._layout_weights(ids.view(shape), plan)
    counts = torch.bincount(got.reshape(-1).long(),
                            minlength=ids.numel() + 1)
    return got, counts


@pytest.mark.parametrize("case", [PLAN_CASES[3], CASES[2], CASES[5],
                                  K_BELOW_STRIDE])
def test_dx_weight_layout(case):
    """``_layout_weights`` for dX (phase-fused) puts ``w[g*og + o, c,
    j0_r + s*m]`` at ``[g*n_nt + c // CO, d_r - m - t_off, o // 8,
    (c % CO)*s + r, o % 8]``: each (phase, tap, o, c) exactly once, zeros
    everywhere else."""
    b, t, cin, cout, k, stride, pad, groups = case
    plan = gc._plan_conv(True, b, cin, cout, k, stride, pad, t,
                         gc.out_length(t, k, stride, pad, pad), groups)
    og, cg = plan.CR, plan.CO_total
    w = torch.randn(cout, cg, k, generator=torch.Generator().manual_seed(0))
    got = gc._layout_weights(w, plan)
    assert got.shape == (groups * plan.n_nt, plan.KE, plan.C8, plan.nt_w, 8)
    want = torch.zeros_like(got)
    for r, (j0, n, d) in enumerate(gc.phases(k, stride, pad)):
        for m in range(n):
            for c in range(cg):
                nt, co = divmod(c, plan.CO)
                for o in range(og):
                    want[nt::plan.n_nt, d - m - plan.t_off, o // 8,
                         co * stride + r, o % 8] = (
                        w.view(groups, og, cg, k)[:, o, c, j0 + stride * m])
    assert torch.equal(got, want)
    _, counts = _layout_ids(plan, (cout, cg, k))
    assert (counts[1:] == 1).all()
    assert counts[0] == got.numel() - w.numel()


@pytest.mark.parametrize("case", PLAN_CASES)
def test_forward_plan_covers_the_work_once(case):
    """``_plan_conv`` for the forward fits shared memory; its CTAs' tiles
    write every (batch row, output channel, output time step) once; its
    chunks cover every tap once, and tap ``j`` of output row ``u`` reads
    window position ``j + s*i``, that is ``x[u*s + j - pad_l]``, inside the
    staged window."""
    b, t, cin, cout, k, stride, pad, groups = case
    t_out = gc.out_length(t, k, stride, pad, pad)
    cg, og = cin // groups, cout // groups

    p = gc._plan_conv(False, b, cin, cout, k, stride, pad, t, t_out, groups)
    _check_smem(p)
    assert (p.S, p.R, p.KE, p.CR, p.CO_total) == (stride, 1, k, cg, og)
    assert (p.C_src, p.T_src, p.C_dst, p.T_dst) == (cin, t, cout, t_out)
    assert p.t_off == -pad and p.n_tt == gc._cdiv(t_out, p.bm)
    assert (_tile_coverage(p) == 1).all()
    for tt in range(p.n_tt):
        for j in range(k):
            plane, row = p.tap_rows(j)
            for i in (0, p.bm - 1):
                pos = plane + stride * (row + i)
                assert tt * p.bm * stride + p.t_off + pos \
                    == (tt * p.bm + i) * stride + j - pad


@pytest.mark.parametrize("case", [PLAN_CASES[3], CASES[2], CASES[5],
                                  K_BELOW_STRIDE])
def test_fwd_weight_layout(case):
    """``_layout_weights`` for the forward puts ``w[g*og + o, c, j]`` at
    ``[g*n_nt + o // CO, j, c // 8, o % CO, c % 8]``: each element once,
    zeros everywhere else."""
    b, t, cin, cout, k, stride, pad, groups = case
    plan = gc._plan_conv(False, b, cin, cout, k, stride, pad, t,
                         gc.out_length(t, k, stride, pad, pad), groups)
    cg, og = plan.CR, plan.CO_total
    w = torch.randn(cout, cg, k, generator=torch.Generator().manual_seed(0))
    got = gc._layout_weights(w, plan)
    assert got.shape == (groups * plan.n_nt, k, plan.C8, plan.nt_w, 8)
    want = torch.zeros_like(got)
    wg = w.view(groups, og, cg, k)
    for o in range(og):
        nt, co = divmod(o, plan.CO)
        for c in range(cg):
            want[nt::plan.n_nt, :, c // 8, co, c % 8] = wg[:, o, c, :]
    assert torch.equal(got, want)
    _, counts = _layout_ids(plan, (cout, cg, k))
    assert (counts[1:] == 1).all()
    assert counts[0] == got.numel() - w.numel()


#: The six main-path geometries cut to B 2, the CASES, K < stride, and two
#: full scale discriminator layers whose slabs do not fit (streamed), cut
#: to short lengths.
EMULATED = ([(2, *case[1:]) for case in PLAN_CASES[:6]] + CASES
            + [K_BELOW_STRIDE, (1, 64, 1024, 1024, 41, 1, 20, 16),
               (1, 128, 512, 1024, 41, 4, 20, 16)])


@pytest.mark.parametrize("kind", ["fwd", "dx"])
@pytest.mark.parametrize("case", EMULATED)
def test_schedule_emulation_matches_plain(case, kind, one_thread):
    """The wgmma kernels' own index arithmetic (CTA ranges, pipes, window
    planes and rows, descriptor row shifts, chunks, fused-phase columns),
    run in f32 on the CPU, equals the plain forward or dX within 1e-5
    relative."""
    b, t, cin, cout, k, stride, pad, groups = case
    t_out = gc.out_length(t, k, stride, pad, pad)
    rng = np.random.default_rng(sum(case))
    w = torch.from_numpy(rng.normal(size=(cout, cin // groups, k))
                         .astype(np.float32))
    plan = gc._plan_conv(kind == "dx", b, cin, cout, k, stride, pad, t,
                         t_out, groups)
    if kind == "fwd":
        x = torch.from_numpy(rng.normal(size=(b, cin, t)).astype(np.float32))
        got, want = (gc.emulate_conv(x, w, plan),
                     gc.conv_fwd_plain(x, w, stride, pad, pad, groups))
    else:
        dy = torch.from_numpy(rng.normal(size=(b, cout, t_out))
                              .astype(np.float32))
        got, want = (gc.emulate_conv(dy, w, plan),
                     gc.conv_dx_plain(dy, w, stride, pad, t, groups))
    assert got.shape == want.shape
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 1e-5, err
    if case[4] == 41 and case[5] in (1, 4) and cin >= 512:
        assert not plan.resident or kind == "dx"


@CLUSTER_TABLES
@pytest.mark.parametrize("case", EMULATED)
def test_dw_emulation_matches_plain(case, clusters, one_thread):
    """``conv_dw_wgmma_kernel``'s own index arithmetic (clusters and ranks,
    row tiles, the staged channel-last window, the register A rows, the
    MN-major descriptor reads per unit, the fixed-order on-chip reduce),
    run in f32 on the CPU, equals the plain dW within 1e-5 relative."""
    b, t, cin, cout, k, stride, pad, groups = case
    t_out = gc.out_length(t, k, stride, pad, pad)
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(size=(b, cin, t)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(b, cout, t_out))
                          .astype(np.float32))
    plan = gc._plan_dw(b, cin, cout, k, stride, pad, t, t_out, groups,
                       clusters)
    got = gc.emulate_dw(x, dy, plan)
    want = gc.conv_dw_plain(x, dy, k, stride, pad, pad, groups)
    assert got.shape == want.shape
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("case", [PLAN_CASES[0], PLAN_CASES[3], CASES[0],
                                  CASES[3], K_BELOW_STRIDE,
                                  (1, 128, 512, 1024, 41, 4, 20, 16)])
def test_dw_descriptor_reads_every_tap(case, one_thread):
    """``_desc_read_mn`` over a staged window, at each unit's start and k16
    step, gives ``x[c, u*s + j - pad_l]`` exactly for every tap ``j`` and
    channel ``c`` of the unit's columns (zero outside x), and its A rows are
    ``dy[o, u]``."""
    b, t, cin, cout, k, stride, pad, groups = case
    b = min(b, 2)
    t_out = gc.out_length(t, k, stride, pad, pad)
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(size=(b, cin, t)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(b, cout, t_out))
                          .astype(np.float32))
    p = gc._plan_dw(b, cin, cout, k, stride, pad, t, t_out, groups,
                    H100_CLUSTERS)
    xp = F.pad(x, (pad, p.stride * (p.BT + p.V) + k))
    cols = torch.arange(p.nt_w)
    for i in (0, p.n_tiles - 1):
        g, ot, ct, part = p.tile(i)
        n_o, n_c = p.extent(i)
        for rt in (0, p.n_rt - 1):
            bb, times = p.rows(rt)
            win, dyt = gc._stage_dw(x, dy, p, i, rt)
            o0 = g * p.og + 64 * ot
            assert torch.equal(dyt[:n_o, :len(times)],
                               dy[bb, o0:o0 + n_o, times.start:times.stop])
            for q in p.part_units(part):
                m, pg = divmod(q, p.n_pg)
                j = m * stride + pg * p.R + cols // p.CO
                c = cols % p.CO
                ok = (pg * p.R + cols // p.CO < stride) & (j < k) & (c < n_c)
                for ks in range(p.BT // 16):
                    got = gc._desc_read_mn(win, p.unit_start(part, q)
                                           + 16 * ks, p.b_lbo, p.b_sbo,
                                           p.nt_w)
                    u = times.start + 16 * ks + torch.arange(16)
                    want = xp[bb, (g * p.cg + p.CO * ct + c[ok])[:, None],
                              u[None] * stride + j[ok, None]]
                    assert torch.equal(got[ok], want)
