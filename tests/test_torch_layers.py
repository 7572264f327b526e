"""The port's conv layers and time-axis helpers against the JAX package
(f32, CPU): weight norm (dense, dilated, grouped, 2-D), spectral norm
(single and dual-batch, with the stored u/v after the update), avg_pool,
moving_average and frame_reduce.

Tolerance rtol 1e-5 / atol 1e-5: the same f32 arithmetic in two
frameworks, differing only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch.ops import conv as tconv
from ste_gan_torch.ops.framing import frame_reduce as t_frame_reduce
from ste_gan_tpu.ops import conv as jconv
from ste_gan_tpu.ops.framing import frame_reduce as j_frame_reduce

TOL = dict(rtol=1e-5, atol=1e-5)


def _t_conv(w):
    w = np.asarray(w, np.float32)
    return torch.from_numpy(np.moveaxis(w, (-1, -2), (0, 1)).copy())


def _cl(x):
    """JAX channel-last -> port channel-first tensor."""
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


def _jl(t):
    """Port channel-first tensor -> JAX channel-last numpy array."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


WN_CASES = [
    # (input shape [B, *spatial, C], features, kernel, stride, dilation, pad, groups)
    ((2, 40, 12), 16, (3,), 1, 1, 1, 1),
    ((2, 40, 12), 16, (3,), 1, 9, 9, 1),
    ((2, 40, 16), 32, (9,), 2, 1, 4, 4),
    ((2, 12, 3, 8), 16, (3, 1), (3, 1), 1, ((2, 2), (0, 0)), 1),
]


@pytest.mark.parametrize("case", WN_CASES)
def test_wn_conv_matches_jax(case):
    shape, feats, k, s, d, pad, g = case
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    jm = jconv.WNConv(feats, k, strides=s, dilation=d, padding=pad, groups=g)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # A trained g differs from ||v||: exercise the reparameterisation.
    params = dict(params, g=params["g"] * 1.5)
    want = jm.apply({"params": params}, jnp.asarray(x))

    tpad = pad if isinstance(pad, int) else tuple(p[0] for p in pad)
    tm = tconv.WNConv(shape[-1], feats, k, stride=s, dilation=d,
                      padding=tpad, groups=g)
    v = _t_conv(params["v"])
    tm.load_state_dict({"weight_v": v, "weight_g": torch.tensor(
        np.asarray(params["g"]).reshape((-1,) + (1,) * (v.dim() - 1))),
        "bias": torch.tensor(np.asarray(params["bias"]))})
    got = tm(_cl(x))
    np.testing.assert_allclose(_jl(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("groups", [1, 4])
def test_sn_conv_matches_jax_and_updates_state(dual, groups):
    rng = np.random.default_rng(1)
    b = 2
    x = rng.normal(size=(2 * b if dual else b, 48, 8)).astype(np.float32)
    jm = jconv.SNConv(16, (9,), strides=2, padding=4, groups=groups)
    var = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), update_stats=False)
    want, mutated = jm.apply(var, jnp.asarray(x), update_stats=True,
                             dual_batch=b if dual else None,
                             mutable=["spectral"])
    spec = mutated["spectral"]

    tm = tconv.SNConv(8, 16, 9, stride=2, padding=4, groups=groups)
    kernel = np.asarray(var["params"]["kernel"])
    v0 = np.moveaxis(np.asarray(var["spectral"]["v"]).reshape(
        kernel.shape[:-1]), -1, 0).reshape(-1)
    tm.load_state_dict({
        "weight_orig": _t_conv(kernel),
        "bias": torch.tensor(np.asarray(var["params"]["bias"])),
        "weight_u": torch.tensor(np.asarray(var["spectral"]["u"])),
        "weight_v": torch.from_numpy(v0)})
    tm.train()
    got = tm(_cl(x), dual_batch=b if dual else None)
    np.testing.assert_allclose(_jl(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(tm.weight_u.numpy(), np.asarray(spec["u"]),
                               rtol=1e-5, atol=1e-6)
    v_jax_order = np.moveaxis(tm.weight_v.numpy().reshape(
        kernel.shape[1], kernel.shape[0]), 0, -1).reshape(-1)
    np.testing.assert_allclose(v_jax_order, np.asarray(spec["v"]),
                               rtol=1e-5, atol=1e-6)

    # Eval reuses the stored vectors.
    tm.eval()
    want_eval = jm.apply({"params": var["params"], "spectral": spec},
                         jnp.asarray(x), update_stats=False)
    u_before = tm.weight_u.clone()
    np.testing.assert_allclose(_jl(tm(_cl(x))), np.asarray(want_eval), **TOL)
    assert torch.equal(u_before, tm.weight_u)


def test_avg_pool_counts_padding():
    x = np.random.default_rng(2).normal(size=(2, 33, 5)).astype(np.float32)
    want = jconv.avg_pool1d(jnp.asarray(x), window=4, stride=2, padding=1)
    got = tconv.avg_pool1d(_cl(x), 4, 2, 1)
    np.testing.assert_allclose(_jl(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [9, 40])
def test_moving_average(window):
    x = np.random.default_rng(3).normal(size=(2, 100, 8)).astype(np.float32)
    want = jconv.moving_average(jnp.asarray(x), window)
    got = tconv.moving_average(_cl(x), window)
    np.testing.assert_allclose(_jl(got), np.asarray(want), **TOL)


def test_upsample_and_reflect_pad():
    x = np.random.default_rng(4).normal(size=(2, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _jl(tconv.upsample_nearest(_cl(x), 2)),
        np.asarray(jconv.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        _jl(tconv.reflect_pad_time(_cl(x), (0, 3))),
        np.asarray(jconv.reflect_pad_time(jnp.asarray(x), (0, 3))))


@pytest.mark.parametrize("window,stride,mode", [(20, 8, "mean"),
                                                (51, 13, "sum"),
                                                (80, 16, "mean")])
def test_frame_reduce_drops_remainder(window, stride, mode):
    x = np.random.default_rng(5).normal(size=(2, 203, 8)).astype(np.float32)
    want = j_frame_reduce(jnp.asarray(x), window, stride, mode)
    got = t_frame_reduce(_cl(x), window, stride, mode)
    assert _jl(got).shape == want.shape
    np.testing.assert_allclose(_jl(got), np.asarray(want), **TOL)
