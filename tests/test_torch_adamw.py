"""The port's AdamW (plain version on the CPU) against the JAX Pallas
AdamW kernel in interpret mode, over 5 steps at b1 .8 / b2 .99.

Tolerance rtol 1e-5 / atol 1e-7, the JAX kernel's own against optax
(tests/test_fused_adamw.py): the port writes p' directly where JAX applies
p + (p' - p), which differs by at most one rounding of p.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch.ops.fused_adamw import (
    adamw_init, fused_adamw_, set_learning_rate)
from ste_gan_tpu.ops.fused_adamw import FusedAdamWState, fused_adamw_update

SHAPES = {"w": (300, 70), "b": (70,), "small": (3,), "conv": (37, 16, 32)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def test_matches_pallas_kernel_over_steps():
    lr, b1, b2, eps, wd = 2e-4, 0.8, 0.99, 1e-8, 1e-2
    params = _params()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = FusedAdamWState(jnp.zeros((), jnp.int32),
                             jax.tree.map(jnp.zeros_like, jp),
                             jax.tree.map(jnp.zeros_like, jp))
    keys = list(params)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    state = adamw_init(tp, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=wd)
    for step in range(5):
        rng = np.random.default_rng(100 + step)
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in SHAPES.items()}
        jp, jstate = fused_adamw_update(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=wd, interpret=True)
        fused_adamw_(state, [torch.from_numpy(grads[k]) for k in keys])
    assert int(state.count) == 5
    for i, k in enumerate(keys):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state.exp_avg[i].numpy(),
                                   np.asarray(jstate.mu[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state.exp_avg_sq[i].numpy(),
                                   np.asarray(jstate.nu[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_learning_rate_is_written_in_place():
    p = [torch.ones(10)]
    state = adamw_init(p, lr=2e-4)
    set_learning_rate(state, 1e-5)
    assert float(state.hyper[0]) == pytest.approx(1e-5)
    fused_adamw_(state, [torch.ones(10)])
    # First step: |update| = lr * (1 + wd*p) with |m_hat/sqrt(v_hat)| ~ 1.
    assert float((1.0 - p[0]).abs().max()) < 2e-5


def test_rejects_mismatched_gradients():
    state = adamw_init([torch.ones(4)], lr=1e-3)
    with pytest.raises(TypeError):
        fused_adamw_(state, [torch.ones(5)])
