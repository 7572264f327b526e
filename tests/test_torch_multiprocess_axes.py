"""The port's cross-process axes worker (``python -m
ste_gan_torch.parallel.multiprocess_axes``) on two spawned CPU gloo
processes per mode (rendezvous through files under ``tmp_path``), against
the JAX worker's single-process oracle (``tests/test_multiprocess_axes.py``:
the sequential stack at the pipeline's microbatch shape, the unsharded MoE
block) on the same weights (the JAX worker's initialisation, carried over
with ``ste_gan_torch.interop``) and the same numpy-seeded inputs:

* the forward within rtol 1e-4 / atol 2e-6 and the re-replicated gradients
  of ``mean(y ** 2)`` within rtol 1e-3 / atol 1e-5, that file's
  tolerances;
* both processes' dumps (forward, gradients, weights after the AdamW step)
  equal bit for bit;
* the weights after each process's AdamW step on its own set against the
  port's one-process oracle: AdamW's first step moves a weight by about
  ``lr`` in the direction of its gradient's sign, so a gradient within
  rounding of 0 may step the other way: held within ``2 lr``.
"""
import concurrent.futures as cf
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import interop
from ste_gan_torch.parallel import multiprocess_axes as axes
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.models.moe import MoEFeedForward as JMoE
from ste_gan_tpu.parallel.pipeline_parallel import (
    stack_stage_params, transformer_stack_layer_fn)

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
MODES = ("pipeline", "expert")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_pipeline(weights: Path):
    """The JAX worker's ``pipeline_setup`` weights, saved for the port; the
    oracle forward and gradients on the port's input."""
    model = JEnc(model_size=axes.D_MODEL, num_extra_res_blocks=1,
                 num_transformer_layers=axes.LAYERS, num_heads=axes.HEADS,
                 dim_feedforward=axes.FF, dropout=0.0)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16 * 16, 8)), train=False))
    torch.save(interop.to_torch(interop.encoder_variables_to_state_dict(
        variables)), weights)
    layer_fn = transformer_stack_layer_fn(axes.D_MODEL, axes.HEADS, axes.FF)
    stacked = stack_stage_params([variables["params"][f"transformer_{i}"]
                                  for i in range(axes.LAYERS)])
    _, x = axes.pipeline_setup("cpu")
    x = jnp.asarray(x.numpy())
    mb = x.shape[0] // axes.MICROBATCHES

    def seq(sp, xx):
        # The layer loop on each microbatch at its own shape (vmapped).
        h = xx.reshape(axes.MICROBATCHES, mb, *xx.shape[1:])
        for s in range(axes.LAYERS):
            h = jax.vmap(lambda hb, s=s: layer_fn(
                jax.tree.map(lambda p: p[s], sp), hb))(h)
        return h.reshape(xx.shape)

    y = jax.jit(seq)(stacked, x)
    grads = jax.jit(jax.grad(lambda sp: jnp.mean(jnp.square(seq(sp, x)))))(
        stacked)
    per_layer = [jax.tree.map(lambda a, i=i: np.asarray(a[i]), grads)
                 for i in range(axes.LAYERS)]
    return np.asarray(y), interop.encoder_variables_to_state_dict(
        {"params": {f"transformer_{i}": t for i, t in enumerate(per_layer)}})


def _jax_expert(weights: Path):
    moe = JMoE(num_experts=axes.EXPERTS, dim_feedforward=axes.FF, top_k=2)
    _, x = axes.moe_setup("cpu")
    x = jnp.asarray(x.numpy())
    params = jax.device_get(moe.init(jax.random.PRNGKey(0), x)["params"])
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in params.items()},
               weights)
    y = jax.jit(lambda p: moe.apply({"params": p}, x))(params)
    grads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(
        moe.apply({"params": p}, x)))))(params)
    return np.asarray(y), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("axes")
    oracles = {}

    def spawn(mode):
        out = tmp / mode
        run_ranks([sys.executable, "-m",
                   "ste_gan_torch.parallel.multiprocess_axes", "--mode", mode,
                   "--out", str(out), "--weights", str(tmp / f"{mode}.pt"),
                   "--device", "cpu", "--timeout_s", "120",
                   "--init_method",
                   f"file://{(tmp / f'{mode}.rendezvous').resolve()}"],
                  2, tmp / f"{mode}_logs", 240, env=RANK_ENV)
        return out

    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        jobs = {}
        for mode, jax_oracle in (("pipeline", _jax_pipeline),
                                 ("expert", _jax_expert)):
            oracles[mode] = jax_oracle(tmp / f"{mode}.pt")
            jobs[mode] = pool.submit(spawn, mode)
        outs = {mode: job.result() for mode, job in jobs.items()}
    port = {mode: axes.oracle(mode, "cpu", tmp / f"{mode}.pt")
            for mode in MODES}
    return outs, oracles, port


@pytest.mark.parametrize("mode", MODES)
def test_forward_and_grads_match_the_single_process_oracle(workers, mode):
    outs, oracles, _ = workers
    want_y, want_grads = oracles[mode]
    got_y = np.load(outs[mode] / "fwd_p0.npy")
    np.testing.assert_allclose(got_y, want_y, rtol=1e-4, atol=2e-6,
                               err_msg=f"{mode} forward")
    got = dict(np.load(outs[mode] / "grads_p0.npz"))
    assert set(got) == set(want_grads)
    for key in sorted(want_grads):
        np.testing.assert_allclose(
            got[key], want_grads[key], rtol=1e-3, atol=1e-5,
            err_msg=f"2-process {mode} grads != 1-process at {key}")


@pytest.mark.parametrize("mode", MODES)
def test_replicas_agree_across_processes(workers, mode):
    outs, _, _ = workers
    out = outs[mode]
    np.testing.assert_array_equal(np.load(out / "fwd_p0.npy"),
                                  np.load(out / "fwd_p1.npy"))
    for name in ("grads", "state"):
        p0 = dict(np.load(out / f"{name}_p0.npz"))
        p1 = dict(np.load(out / f"{name}_p1.npz"))
        assert set(p0) == set(p1)
        for key in p0:
            np.testing.assert_array_equal(p0[key], p1[key],
                                          err_msg=f"{name} {key}")


@pytest.mark.parametrize("mode", MODES)
def test_each_process_steps_its_own_set_as_one_process_does(workers, mode):
    outs, _, port = workers
    want_y, want_grads, want_state = port[mode]
    np.testing.assert_allclose(np.load(outs[mode] / "fwd_p0.npy"), want_y,
                               rtol=1e-4, atol=2e-6)
    got = dict(np.load(outs[mode] / "state_p0.npz"))
    assert set(got) == set(want_state)
    init = torch.load(outs[mode].parent / f"{mode}.pt", weights_only=True)
    for key, value in want_state.items():
        np.testing.assert_allclose(got[key], value, rtol=0,
                                   atol=2 * axes.LR, err_msg=key)
        # The step ran on every leaf of each process's set.
        assert not np.array_equal(got[key], init[key].numpy()), key
