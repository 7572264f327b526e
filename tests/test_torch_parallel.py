"""The port's data-parallel and fully-sharded GAN step over two CPU ranks
(spawned gloo processes of ``python -m ste_gan_torch.parallel.multiprocess``,
rendezvous through a file under ``tmp_path``), against the port at one
rank and against a JAX step over a 2-device ``data`` mesh.

Every run starts from one JAX initial state (``tiny_setup``'s geometry,
the generator EMA on) and one frozen encoder, carried to the port by
``interop`` and handed to the worker as a full-state checkpoint; the
batches are the worker's ``(seed, step)`` batches, which the JAX side
shards over its mesh. Three steps.

Tolerances and why:
* losses per step: rtol 1e-4 / atol 1e-6 (``tests/test_torch_train_step.py``).
  Two ranks average two half-batch means where one rank takes one mean:
  f32 sums in another order;
* parameters and EMA: rtol 1e-4 / atol 5e-5, a quarter of one AdamW step
  (lr 2e-4), where ``tests/test_torch_train_step.py`` has atol 1e-5;
  first and second moments: rtol 1e-3 / atol 1e-4, where it has atol
  1e-6; spectral u/v: rtol 1e-4 / atol 1e-6. Why wider: two ranks sum two
  8-row gradients where one rank sums 16 rows, and the CPU convolutions
  round those sums differently (the two-rank D gradient of step 0 is
  within 8.3e-7 of one rank's, and equals the mean of the two half-batch
  gradients computed in one process bit for bit). AdamW scales every
  coordinate's step by its own gradient's size, so a small gradient that
  comes out of a cancellation (weight norm projects the weight's gradient
  off ``v``) moves by a fraction of a step, and three adversarial steps
  carry that on: after three steps one of the 10,240 elements of
  ``gblocks.0.weight_v`` lies 3.1e-5 away and the G moments up to 3.5e-3
  of values up to 3.4. That this is rounding and not the reduction: two
  ranks given the same rows equal one rank bit for bit (the last test),
  and the losses agree to 2e-7;
* both ranks' final states: equal bit for bit (the same all-reduced
  gradients, the same updates);
* FSDP against DP at two ranks: equal bit for bit. A two-rank sum is one
  addition either way (all-reduce or reduce-scatter), and AdamW and the
  EMA are elementwise, so slices of a flat buffer update as the leaves do.
"""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import interop
from ste_gan_torch.parallel import mesh
from ste_gan_torch.parallel.fsdp import fsdp_sharding_summary
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.parallel.multiprocess import (
    flatten_state, run_steps, seeded_batch, tiny_setup)
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train.checkpoint import host_copy
from ste_gan_tpu.parallel.mesh import create_mesh, replicate
from ste_gan_tpu.parallel.mesh import largest_divisor_mesh_size as j_divisor
from ste_gan_tpu.parallel.mesh import shard_batch as j_shard_batch
from ste_gan_tpu.parallel.multiprocess import tiny_setup as j_tiny_setup
from ste_gan_tpu.train import gan as jgan

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
#: Seconds a spawned two-rank run may take before it is torn down.
RANKS_TIMEOUT = 240
#: Each spawned rank: one intra-op thread (the models are tiny, and
#: parallel test workers share the cores), the repo importable.
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}


def run_worker(tmp: Path, name: str, world: int, *flags):
    """The worker CLI on ``world`` CPU ranks; returns the per-rank
    ``(states, histories, stats)``."""
    out = tmp / name
    cmd = [sys.executable, "-m", "ste_gan_torch.parallel.multiprocess",
           "--device", "cpu", "--steps", str(STEPS), "--out", str(out),
           "--timeout_s", "90",
           "--init_method", f"file://{(tmp / f'{name}.rendezvous').resolve()}",
           *flags]
    run_ranks(cmd, world, out, RANKS_TIMEOUT, env=RANK_ENV)
    states = [dict(np.load(out / f"state_p{r}.npz")) for r in range(world)]
    histories = [json.loads((out / f"history_p{r}.json").read_text())
                 for r in range(world)]
    stats = [json.loads((out / f"stats_p{r}.json").read_text())
             for r in range(world)]
    return states, histories, stats


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """The JAX tiny setup's initial state (EMA on) and frozen encoder, and
    the same as the worker's ``--restore_ckpt`` / ``--encoder_ckpt``."""
    tmp = tmp_path_factory.mktemp("start")
    jcfg, jmodels = j_tiny_setup()
    jcfg.train.generator_ema = 0.999
    jstate = jgan.init_state(jcfg, jmodels, jax.random.PRNGKey(0))
    enc_vars = jmodels.encoder.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 512, 8)), train=False)
    cfg, models = tiny_setup()
    interop.load_encoder(models.encoder, enc_vars)
    state = tgan.init_state(cfg, models)
    interop.train_state_from_jax(jstate, models, state)
    torch.save(host_copy(tgan.state_tree(models, state)), tmp / "init.pt")
    torch.save(host_copy(models.encoder.state_dict()), tmp / "encoder.pt")
    return {"tmp": tmp, "init": tmp / "init.pt",
            "encoder": tmp / "encoder.pt", "jax": (jcfg, jmodels, jstate,
                                                   enc_vars)}


def _flags(start):
    return ("--restore_ckpt", str(start["init"]), "--encoder_ckpt",
            str(start["encoder"]))


def _world_one(start, grad_accum=1, fsdp=False):
    """The same run in this process, one rank (no process group)."""
    cfg, models = tiny_setup()
    cfg.train.grad_accum = grad_accum
    models.encoder.load_state_dict(torch.load(start["encoder"],
                                              weights_only=True))
    tree, history, _ = run_steps(cfg, models, STEPS, fsdp=fsdp,
                                 restore_ckpt=start["init"])
    return flatten_state(tree), history


@pytest.fixture(scope="module")
def world_one(start):
    return _world_one(start)


@pytest.fixture(scope="module")
def dp(start):
    return run_worker(start["tmp"], "dp", 2, *_flags(start))


@pytest.fixture(scope="module")
def fsdp(start):
    return run_worker(start["tmp"], "fsdp", 2, "--fsdp", *_flags(start))


@pytest.fixture(scope="module")
def jax_mesh(start):
    """Three JAX steps over a 2-device ``data`` mesh on the worker's
    batches, carried into the port's state layout."""
    jcfg, jmodels, jstate, enc_vars = start["jax"]
    data = create_mesh(2)
    state = replicate(data, jstate)
    enc = replicate(data, enc_vars)
    step = jax.jit(jgan.make_train_step(jcfg, jmodels))
    history = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in seeded_batch(
            tiny_setup()[0], 0, i).items()}
        state, m = step(state, j_shard_batch(data, batch), enc)
        history.append({"G": float(m["loss/generator"]),
                        "D": float(m["loss/discriminator"])})
    cfg, models = tiny_setup()
    port_state = tgan.init_state(cfg, models)
    interop.train_state_from_jax(jax.device_get(state), models, port_state)
    return flatten_state(tgan.state_tree(models, port_state)), history


def _tolerance(key: str):
    """(rtol, atol) of a flattened state entry (see the module docstring)."""
    if key.endswith(("weight_u", "weight_v")) and key.startswith(
            "discriminator/"):
        return 1e-4, 1e-6
    if "/exp_avg" in key:
        return 1e-3, 1e-4
    return 1e-4, 5e-5


def assert_states_close(got, want, what):
    assert set(got) == set(want), set(got) ^ set(want)
    for key in sorted(want):
        rtol, atol = _tolerance(key)
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {key}")


def assert_histories_close(got, want, what):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("G", "D"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{what}: {k} at step {i}")


# ---------------------------------------------------------------------------
# mesh.py helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch, requested", [
    (32, 8), (32, 3), (16, 5), (12, 7), (7, 4), (1, 8), (48, 100)])
def test_largest_divisor_mesh_size_matches_jax(batch, requested):
    assert mesh.largest_divisor_mesh_size(batch, requested) == j_divisor(
        batch, requested)


def test_a_rank_count_that_does_not_divide_the_batch_raises():
    assert mesh.check_divides(32, 4, "global batch") == 8
    with pytest.raises(ValueError, match="cannot be dropped"):
        mesh.check_divides(32, 3, "global batch")
    with pytest.raises(ValueError, match="do not divide"):
        mesh.shard_batch({"x": np.zeros((6, 2))}, 0, 4)
    # The refusal names the rank count the JAX trainer would clamp to.
    with pytest.raises(ValueError, match=r"e\.g\. 4\)"):
        mesh.check_divides(12, 5, "global batch")


def test_the_trainers_rank_count_rule_and_validation_split(monkeypatch):
    from ste_gan_torch.parallel.tensor_parallel import mesh_shape

    for requested in (-1, 0, 2):
        assert mesh_shape(2, requested, 1) == (2, 1)
    with pytest.raises(ValueError, match="data_parallel 4 .* but 2 rank"):
        mesh_shape(2, 4, 1)
    assert list(mesh.round_robin(5, None)) == [0, 1, 2, 3, 4]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_ranks() == (0, None, False)  # no WORLD_SIZE: no group


def test_shard_and_constrain_batch_give_each_rank_its_rows():
    batch = seeded_batch(tiny_setup()[0], 0, 0)
    parts = [mesh.shard_batch(batch, r, 4) for r in range(4)]
    for key, value in batch.items():
        np.testing.assert_array_equal(
            np.concatenate([p[key].numpy() for p in parts]), value)
    on_device = {k: torch.from_numpy(v) for k, v in batch.items()}
    for r in range(4):
        views = mesh.constrain_batch(on_device, r, 4)
        for key in batch:
            assert torch.equal(views[key], parts[r][key])
            assert views[key].data_ptr() == on_device[key][4 * r:].data_ptr()
    assert mesh.world() == (0, 1, None)
    grads = mesh.allreduce_grads_([torch.ones(3)], None)  # no group: as is
    assert torch.equal(grads[0], torch.ones(3))


# ---------------------------------------------------------------------------
# The GAN step over two ranks
# ---------------------------------------------------------------------------


def test_two_rank_data_parallel_matches_one_rank(dp, world_one):
    states, histories, stats = dp
    want_state, want_history = world_one
    assert_histories_close(histories[0], want_history, "losses")
    assert_states_close(states[0], want_state, "state")
    assert int(states[0]["step"]) == STEPS
    assert int(states[0]["opt_g/count"]) == STEPS
    assert stats[0]["ranks"] == 2 and stats[0]["comm_s"] > 0


def test_two_rank_data_parallel_matches_the_jax_data_mesh(dp, jax_mesh):
    states, histories, _ = dp
    want_state, want_history = jax_mesh
    assert_histories_close(histories[0], want_history, "losses vs JAX")
    assert_states_close(states[0], want_state, "state vs JAX")


@pytest.mark.parametrize("run", ["dp", "fsdp"])
def test_both_ranks_end_bit_identical(run, request):
    states, histories, _ = request.getfixturevalue(run)
    assert set(states[0]) == set(states[1])
    for key in states[0]:
        np.testing.assert_array_equal(states[0][key], states[1][key],
                                      err_msg=key)
    assert [(h["G"], h["D"]) for h in histories[0]] == [
        (h["G"], h["D"]) for h in histories[1]]


def test_fsdp_equals_data_parallel_bit_for_bit(fsdp, dp):
    got, want = fsdp[0][0], dp[0][0]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert [(h["G"], h["D"]) for h in fsdp[1][0]] == [
        (h["G"], h["D"]) for h in dp[1][0]]


def test_fsdp_holds_about_half_the_state_per_rank(fsdp):
    _, models = tiny_setup()
    summary = fsdp_sharding_summary(models, ema=True, size=2)
    held = [s["persistent_bytes"] for s in fsdp[2]]
    assert held == [summary["per_rank_bytes"]] * 2
    share = summary["per_rank_bytes"] / summary["replicated_bytes"]
    assert 0.5 <= share < 0.52, share
    assert fsdp_sharding_summary(models, ema=True, size=1)[
        "per_rank_bytes"] == summary["replicated_bytes"]
    at_8 = fsdp_sharding_summary(models, ema=True, size=8)
    assert at_8["per_rank_bytes"] < summary["per_rank_bytes"] / 3


def test_fsdp_at_one_rank_equals_the_replicated_step(start, world_one):
    got, history = _world_one(start, fsdp=True)
    want, want_history = world_one
    assert [(h["G"], h["D"]) for h in history] == [
        (h["G"], h["D"]) for h in want_history]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_accumulating_step_at_two_ranks_matches_one_rank(start):
    states, histories, _ = run_worker(start["tmp"], "accum", 2,
                                      "--grad_accum", "2", *_flags(start))
    want_state, want_history = _world_one(start, grad_accum=2)
    assert_histories_close(histories[0], want_history, "accumulated losses")
    assert_states_close(states[0], want_state, "accumulated state")


def test_two_ranks_on_the_same_rows_equal_one_rank_bit_for_bit(tmp_path):
    """Both ranks get the same 8 rows (the first 8 of each seeded batch);
    the mean of two equal gradients is the gradient, so the run must equal
    one rank on those 8 rows exactly: the all-reduce, the metrics and the
    EMA add nothing of their own."""
    cmd = [sys.executable, __file__, str(tmp_path)]
    run_ranks(cmd, 2, tmp_path / "logs", RANKS_TIMEOUT, env=RANK_ENV)
    _same_rows_rank(tmp_path, single=True)
    want = dict(np.load(tmp_path / "state_single.npz"))
    for rank in range(2):
        got = dict(np.load(tmp_path / f"state_p{rank}.npz"))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _same_rows_rank(out: Path, single: bool = False):
    """One rank of the same-rows run, or (``single``) one process on the
    8 rows alone."""
    import ste_gan_torch.parallel.multiprocess as worker

    seeded = worker.seeded_batch
    cfg, models = tiny_setup()

    def first_rows(c, seed, step):
        rows = {k: v[:8] for k, v in seeded(cfg, seed, step).items()}
        return rows if single else {k: np.concatenate([v, v])
                                    for k, v in rows.items()}

    group, name = None, "state_single.npz"
    if not single:
        rank, _, group = mesh.init_distributed(
            "gloo", 90, "cpu", f"file://{(out / 'rendezvous').resolve()}")
        name = f"state_p{rank}.npz"
    worker.seeded_batch = first_rows
    try:
        run_cfg = tiny_setup()[0]
        run_cfg.train.batch_size = 8 if single else 16
        tree, _, _ = run_steps(run_cfg, models, STEPS, group=group)
    finally:
        worker.seeded_batch = seeded
    np.savez(out / name, **flatten_state(tree))
    if group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _same_rows_rank(Path(sys.argv[1]))
