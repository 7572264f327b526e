"""The port's grouped conv1d (autograd function over the Hopper kernels'
plain versions on the CPU) against the JAX Pallas kernel in interpret mode
and XLA's grouped conv: values, dX and dW, f32.

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
    """The dilate-and-flip dX and the per-tap dW equal torch autograd of
    the plain forward (rtol 1e-4 / atol 1e-5, f32)."""
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
