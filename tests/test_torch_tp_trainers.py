"""Both trainers under tensor parallelism (``parallel/tensor_parallel.py``)
on spawned CPU gloo ranks (rendezvous through files under ``tmp_path``),
against the JAX package's ``(data, model)`` meshes on its 8 virtual CPU
devices and against the port at one rank.

* The GAN step through the worker (``python -m
  ste_gan_torch.parallel.multiprocess --model_parallel P``), 3 f32 steps
  of the JAX worker's tiny setup from one JAX initial state (EMA on) at
  ``(data, model)`` = (1, 2), (2, 2) and (1, 4): losses within rtol 2e-4
  and every leaf of the full (gathered) state within rtol 2e-3 / atol
  1e-5 (``tests/test_tensor_parallel.py``'s tolerances) of JAX's (4, 2)
  and (2, 4) ``create_mesh_2d`` trajectories and of the port's world 1.
  At (2, 2) the data axis adds the rounding of data parallelism: two
  half-batch gradients averaged where one rank takes one mean, which
  AdamW carries into a few first-moment coordinates (up to 1.4e-4 after
  three steps; ``tests/test_torch_parallel.py`` explains it and holds the
  moments at atol 1e-4). The (2, 1) data-parallel run of the same rows
  shows the same leaves off by the same amounts, so (2, 2) is held to it
  at the tolerances above, and to world 1 and JAX with the moments at
  atol 1e-4. The ranks end bit for bit equal, and the leaves the rule replicates
  (and their first moments, linear in their gradients) are bit for bit
  equal on every model rank: their gradients are identical there.
  Hybrid FSDP x TP at (2, 2) equals TP at (2, 2) bit for bit, and the
  (1, 2) run's step-2 recovery point redoes step 3 under ``--fsdp`` bit
  for bit.
* ``train_gan`` at (1, 2): its logged metrics within rtol 1e-4 / atol
  1e-6 of world 1; its step-2 checkpoint (single-device format) resumed at
  world 1 and at (2, 1) gives the uninterrupted run's step-3 losses.
* The encoder step at (2, 2): 3 voiced steps (shift pinned, dropout 0)
  against the JAX (4, 2) mesh and against world 1, at the tolerances of
  ``tests/test_torch_encoder_step.py`` (rtol 1e-3 / atol 2e-5; the conv
  biases that feed a BatchNorm have no true gradient and are held to the
  AdamW drift ceiling); ``train.encoder --model_parallel 2`` at two ranks
  (mixed corpus, dropout 0.2) logs what one rank logs (rtol 1e-4 / atol
  1e-6).
* The refusals: a world that is not data x model, pipeline stages with
  model parallelism, a pipelined MoE encoder.

The spawned runs go in a pool of three at a time beside the JAX runs.
"""
import concurrent.futures as cf
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ste_gan_torch import interop
from ste_gan_torch.config import Config
from ste_gan_torch.config import create_ste_gan_model_name
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.ops.fused_adamw import set_learning_rate
from ste_gan_torch.parallel import pipeline_parallel as pp
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.parallel.multiprocess import (
    flatten_state, run_steps, seeded_batch, tiny_setup)
from ste_gan_torch.train import encoder as tenc
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train import train_gan as ttrain
from ste_gan_torch.train.checkpoint import host_copy
from ste_gan_torch.train.encoder_data import fold_encoder_batch
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.parallel.multiprocess import tiny_setup as j_tiny_setup
from ste_gan_tpu.parallel.tensor_parallel import (
    create_mesh_2d, shard_batch_2d, shard_state)
from ste_gan_tpu.train import encoder as jenc
from ste_gan_tpu.train import gan as jgan

from tests.test_torch_encoder_step import _items

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
STEPS = 3
TIMEOUT = 240
#: (data, model) of each worker run; the JAX mesh each is held to.
LAYOUTS = {"tp_1x2": ((1, 2), (4, 2)), "tp_2x2": ((2, 2), (4, 2)),
           "tp_1x4": ((1, 4), (2, 4))}
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)
ENC_TOL = dict(rtol=1e-3, atol=2e-5)
ENC_MAX_SAMPLES = 8
ENC_N_WIN = 4
ENC_SHIFT = 5
GAN_ENCODER = {"type": "EMGEncoderTransformer",
               "params": {"model_size": 32, "num_extra_res_blocks": 3,
                          "num_transformer_layers": 1, "num_heads": 4,
                          "dim_feedforward": 64, "dropout": 0.0}}
DISC = {"num_multi_pool": 1, "num_multi_scale": 1,
        "period_spec_override": [[8, 3, 1, 2], [16, 3, 3, 2]],
        "scale_spec_override": [[8, 15, 1, 1, 7], [16, 9, 2, 4, 4],
                                [32, 9, 2, 8, 4], [32, 5, 1, 1, 2]]}

#: The encoder step at (2, 2) on each of four ranks: the carried initial
#: weights, the saved folded batches, the shift pinned; rank 0 saves the
#: gathered state dict and the losses.
ENCODER_RANK_CODE = r'''
import sys, numpy as np, torch, torch.distributed as dist
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.ops.fused_adamw import set_learning_rate
from ste_gan_torch.parallel import mesh as M
from ste_gan_torch.parallel import pipeline_parallel as pp
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.train import encoder as tenc
out, init = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
M.init_distributed("gloo", 90, "cpu", init)
layout = tp.create_mesh_2d(2, 2)
model = EMGEncoderTransformer(**''' + repr(ENC_KW) + r''')
model.load_state_dict(torch.load(f"{out}/enc_init.pt", weights_only=True))
tp.shard_module_(model, layout)
tenc.random_shift = lambda rng: ''' + repr(ENC_SHIFT) + r'''
state = tenc.init_train_state(model)
step = tenc.make_encoder_train_step(model, ''' + repr(ENC_MAX_SAMPLES) + r''',
                                    group=layout.data)
batches = np.load(f"{out}/enc_batches.npz")
losses = []
for i in range(''' + repr(STEPS) + r'''):
    batch = {k.split("/", 1)[1]: torch.from_numpy(v)
             for k, v in batches.items() if k.startswith(f"{i}/")}
    set_learning_rate(state.opt, tenc.warmup_lr(i, warmup=2))
    state, metrics = step(state, batch)
    losses.append(float(metrics["loss"]))
sd = tp.gather_state_dict(model, layout)
if dist.get_rank() == 0:
    np.savez(f"{out}/enc_tp.npz", losses=np.asarray(losses),
             **{k: v.numpy() for k, v in sd.items()})
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spawn(tmp: Path, name: str, world: int, cmd) -> Path:
    rendezvous = f"file://{(tmp / f'{name}.rendezvous').resolve()}"
    run_ranks([sys.executable, *cmd(rendezvous)], world, tmp / f"{name}_logs",
              TIMEOUT, env=RANK_ENV)
    return tmp / name


def _worker(tmp: Path, name: str, world: int, *flags) -> Path:
    return _spawn(tmp, name, world, lambda rdv: [
        "-m", "ste_gan_torch.parallel.multiprocess", "--device", "cpu",
        "--steps", str(STEPS), "--out", str(tmp / name), "--timeout_s", "90",
        "--init_method", rdv, *flags])


# ---------------------------------------------------------------------------
# The GAN trainer's run directory (tests/test_torch_trainer_dp.py's size)
# ---------------------------------------------------------------------------


def _gan_work(tmp: Path):
    corpus = tmp / "corpus"
    generate_synthetic_corpus(corpus, num_train=8, num_valid=3, num_test=2,
                              num_sessions=3, min_frames=34, max_frames=40,
                              seed=0)
    cfg = Config()
    cfg.data.dataset_root = str(corpus)
    cfg.data.name = "synthetic"
    cfg.data.num_emg_sessions = 3
    t = cfg.train
    t.chunk_size, t.batch_size, t.mixed_precision = 512, 4, False
    t.max_steps, t.interval_log, t.interval_valid = 3, 1, 2
    t.interval_sample, t.interval_save = 10_000, 2
    t.save_last_epoch_interval, t.generator_ema = 1, 0.999
    cfg.model.params = {"channels": 32}
    cfg.model.discriminator_params = DISC
    base = cfg.to_dict()
    data, encoder = base.pop("data"), base.pop("emg_encoder")
    encoder.update(GAN_ENCODER)
    for name, content in (("data", data), ("encoder", encoder)):
        (tmp / f"{name}.yaml").write_text(yaml.safe_dump(content))
    return base, create_ste_gan_model_name(cfg, add_timestamp=False)


def _gan_argv(tmp: Path, base: dict, name: str, *more):
    config = tmp / f"config_{name}.yaml"
    config.write_text(yaml.safe_dump(dict(base,
                                          model_base_dir=str(tmp / name))))
    return ["--config", str(config), "--data", str(tmp / "data.yaml"),
            "--emg_enc_cfg", str(tmp / "encoder.yaml"), "--device", "cpu",
            "--dist_timeout_s", "90", *more]


def _gan_cli(tmp, base, name, world, *more):
    argv = _gan_argv(tmp, base, name, *more)
    if world == 1:
        ttrain.main(ttrain.parse_args(argv))
        return tmp / name
    return _spawn(tmp, name, world, lambda rdv: [
        "-m", "ste_gan_torch.train.train_gan", *argv,
        "--dist_init_method", rdv])


def _logged(run: Path, prefixes=("train", "val/")) -> dict:
    out = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"].startswith(prefixes):
            out[(rec["tag"], rec["step"])] = rec["value"]
    return out


# ---------------------------------------------------------------------------
# The encoder runs
# ---------------------------------------------------------------------------


def _encoder_files(tmp: Path, encoder: dict) -> dict:
    root = tmp / "enc_corpus"
    if not root.exists():
        generate_synthetic_corpus(root, num_train=10, num_valid=3, num_test=2,
                                  num_sessions=2, min_frames=30,
                                  max_frames=50, seed=5,
                                  silent_fraction=0.4)
    files = {}
    for name, content in (
            ("config", {"model_base_dir": str(tmp / "unused")}),
            ("data", {"dataset_root": str(root), "name": "synthetic",
                      "num_emg_sessions": 2, "num_emg_channels": 8}),
            ("encoder", {"type": "EMGEncoderTransformer",
                         "params": encoder})):
        files[name] = tmp / f"enc_{name}_{len(encoder)}.yaml"
        files[name].write_text(yaml.safe_dump(content))
    return files


def _encoder_argv(files: dict, exp: Path):
    return ["--config", str(files["config"]), "--data", str(files["data"]),
            "--emg_enc_cfg", str(files["encoder"]), "--exp_dir", str(exp),
            "--include_silent", "--num_epochs", "1", "--max_batch_len",
            "3200", "--warmup_steps", "5", "--transfer_dtype", "float32",
            "--device", "cpu", "--dist_timeout_s", "90"]


def _encoder_batches(tmp: Path):
    batches = [fold_encoder_batch(_items(30 + i, mixed=False),
                                  n_win=ENC_N_WIN,
                                  max_samples=ENC_MAX_SAMPLES).as_dict()
               for i in range(STEPS)]
    np.savez(tmp / "enc_batches.npz",
             **{f"{i}/{k}": np.asarray(v) for i, b in enumerate(batches)
                for k, v in b.items()})
    return batches


def _encoder_jax_init(emg):
    jm = JEnc(**ENC_KW)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(emg), train=False)
    return jm, variables["params"], variables["batch_stats"]


def _encoder_runs(tmp: Path, batches):
    """JAX at (4, 2) and the port at world 1, from one JAX initial state;
    the port's initial weights saved for the ranks."""
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(ENC_SHIFT, jnp.int32))
    monkeypatch.setattr(tenc, "random_shift", lambda rng: ENC_SHIFT)
    try:
        jm, params, stats = _encoder_jax_init(batches[0]["emg_windows"])
        opt = jenc.make_optimizer()
        jstate = jenc.EncoderTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=opt.init(params))
        tm = TEnc(**ENC_KW)
        tstate = tenc.init_train_state(tm)
        interop.encoder_train_state_from_jax(jstate, tm, tstate)
        torch.save(tm.state_dict(), tmp / "enc_init.pt")
        mesh = create_mesh_2d(4, 2)
        jstate = shard_state(mesh, jstate)
        jstep = jax.jit(jenc.make_encoder_train_step(jm, ENC_MAX_SAMPLES))
        tstep = tenc.make_encoder_train_step(tm, ENC_MAX_SAMPLES)
        jlog, tlog = [], []
        for i, batch in enumerate(batches):
            lr = tenc.warmup_lr(i, warmup=2)
            jstate.opt_state.hyperparams["learning_rate"] = np.float32(lr)
            jstate, jmet = jstep(jstate, shard_batch_2d(mesh, {
                k: jnp.asarray(v) for k, v in batch.items()}), i)
            set_learning_rate(tstate.opt, lr)
            tstate, tmet = tstep(tstate, {k: torch.from_numpy(np.asarray(v))
                                          for k, v in batch.items()})
            jlog.append(float(jmet["loss"]))
            tlog.append(float(tmet["loss"]))
        jstate = jax.device_get(jstate)
        jax_sd = interop.encoder_variables_to_state_dict(
            {"params": jstate.params, "batch_stats": jstate.batch_stats})
        return {"jax": (jlog, jax_sd),
                "one": (tlog, {k: v.numpy()
                               for k, v in tm.state_dict().items()})}
    finally:
        monkeypatch.undo()


# ---------------------------------------------------------------------------
# Every run of the file
# ---------------------------------------------------------------------------


def _jax_gan(start, grid):
    """Three JAX steps over a (data, model) mesh on the worker's batches,
    carried into the port's state layout."""
    jcfg, jmodels, jstate, enc_vars = start["jax"]
    mesh = create_mesh_2d(*grid)
    state = shard_state(mesh, jstate)
    enc = shard_state(mesh, enc_vars)
    step = jax.jit(jgan.make_train_step(jcfg, jmodels))
    history = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in seeded_batch(
            tiny_setup()[0], 0, i).items()}
        state, m = step(state, shard_batch_2d(mesh, batch), enc)
        history.append({"G": float(m["loss/generator"]),
                        "D": float(m["loss/discriminator"])})
    cfg, models = tiny_setup()
    port_state = tgan.init_state(cfg, models)
    interop.train_state_from_jax(jax.device_get(state), models, port_state)
    return flatten_state(tgan.state_tree(models, port_state)), history


def _worker_out(out: Path, world: int):
    states = [dict(np.load(out / f"state_p{r}.npz")) for r in range(world)]
    hist = [json.loads((out / f"history_p{r}.json").read_text())
            for r in range(world)]
    stats = [json.loads((out / f"stats_p{r}.json").read_text())
             for r in range(world)]
    return states, hist, stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_trainers")
    # One JAX initial state (EMA on) and frozen encoder for the GAN runs.
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
    start = {"jax": (jcfg, jmodels, jstate, enc_vars)}
    flags = ("--restore_ckpt", str(tmp / "init.pt"), "--encoder_ckpt",
             str(tmp / "encoder.pt"))
    base, run_name = _gan_work(tmp)
    enc_batches = _encoder_batches(tmp)
    enc_files = _encoder_files(tmp, dict(GAN_ENCODER["params"],
                                         dropout=0.2))
    out = {}
    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        jobs = {name: pool.submit(_worker, tmp, name, d * m, "--model_parallel",
                                  str(m), "--ckpt_every", "2", "--ckpt_dir",
                                  str(tmp / f"{name}_recovery"), *flags)
                for name, ((d, m), _) in LAYOUTS.items()}
        jobs["fsdp_2x2"] = pool.submit(_worker, tmp, "fsdp_2x2", 4,
                                       "--model_parallel", "2", "--fsdp",
                                       *flags)
        jobs["dp_2x1"] = pool.submit(_worker, tmp, "dp_2x1", 2, *flags)
        jobs["gan_tp"] = pool.submit(_gan_cli, tmp, base, "gan_tp", 2,
                                     "--model_parallel", "2")
        # The encoder's initial weights are written before its ranks start.
        enc = _encoder_runs(tmp, enc_batches)
        jobs["enc_tp"] = pool.submit(_spawn, tmp, "enc_tp", 4, lambda rdv: [
            "-c", ENCODER_RANK_CODE, str(tmp), rdv])
        jobs["enc_cli_tp"] = pool.submit(
            _spawn, tmp, "enc_cli_tp", 2, lambda rdv: [
                "-m", "ste_gan_torch.train.encoder",
                *_encoder_argv(enc_files, tmp / "enc_cli_tp"),
                "--model_parallel", "2", "--dist_init_method", rdv])

        # Beside the spawned ranks: the JAX meshes and the world-1 runs.
        out["jax"] = {grid: _jax_gan(start, grid) for grid in ((4, 2), (2, 4))}
        cfg1, models1 = tiny_setup()
        models1.encoder.load_state_dict(torch.load(tmp / "encoder.pt",
                                                   weights_only=True))
        tree, hist, stats = run_steps(cfg1, models1, STEPS,
                                      restore_ckpt=tmp / "init.pt")
        out["one"] = (flatten_state(tree), hist, stats)
        out["gan_one"] = _gan_cli(tmp, base, "gan_one", 1)
        tenc.main(tenc.parse_args(_encoder_argv(enc_files, tmp / "enc_one")))
        results = {name: job.result() for name, job in jobs.items()}
        # The (1, 2) trainer's step-2 checkpoint at world 1 and at (2, 1).
        ckpt = str(tmp / "gan_tp" / run_name / "checkpoint-00000002")
        resumed_dp = pool.submit(_gan_cli, tmp, base, "resume_dp", 2,
                                 "--checkpoint", ckpt)
        # The (1, 2) worker's step-2 recovery point, step 3 redone under
        # hybrid FSDP x TP.
        recovered = pool.submit(
            _worker, tmp, "tp_1x2_recovered", 2, "--model_parallel", "2",
            "--fsdp", "--start_step", "2", "--steps", "1", "--restore_ckpt",
            str(tmp / "tp_1x2_recovery" / "step_2.pt"), flags[2], flags[3])
        out["resume_one"] = _gan_cli(tmp, base, "resume_one", 1,
                                     "--checkpoint", ckpt) / run_name
        out["resume_dp"] = resumed_dp.result() / run_name
        out["tp_1x2_recovered"] = _worker_out(recovered.result(), 2)
    for name, ((d, m), _) in LAYOUTS.items():
        out[name] = _worker_out(results[name], d * m)
    out["fsdp_2x2"] = _worker_out(results["fsdp_2x2"], 4)
    out["dp_2x1"] = _worker_out(results["dp_2x1"], 2)
    out["gan_tp"] = results["gan_tp"] / run_name
    out["gan_one"] = out["gan_one"] / run_name
    out["enc"] = enc
    saved = dict(np.load(tmp / "enc_tp.npz"))
    out["enc"]["tp"] = (list(saved.pop("losses")), saved)
    out["enc_cli"] = (next((tmp / "enc_one").iterdir()),
                      next((results["enc_cli_tp"]).iterdir()))
    return out


# ---------------------------------------------------------------------------
# The GAN step
# ---------------------------------------------------------------------------


def _assert_gan_close(got_state, got_hist, want_state, want_hist, what,
                      moment_atol=1e-5):
    assert len(got_hist) == len(want_hist) == STEPS
    for i, (g, w) in enumerate(zip(got_hist, want_hist)):
        for k in ("G", "D"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4,
                                       err_msg=f"{what}: {k} at step {i}")
    assert set(got_state) == set(want_state), set(got_state) ^ set(want_state)
    for key, want in want_state.items():
        got = got_state[key]
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: {key}")
        else:
            atol = moment_atol if "/exp_avg" in key else 1e-5
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=atol,
                                       err_msg=f"{what}: {key}")


def _moment_atol(layout):
    """Data parallelism's own rounding in the moments (module docstring)."""
    return 1e-4 if LAYOUTS[layout][0][0] > 1 else 1e-5


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_trajectory_matches_world_one(runs, layout):
    states, hist, _ = runs[layout]
    want_state, want_hist, _ = runs["one"]
    _assert_gan_close(states[0], hist[0], want_state, want_hist,
                      f"{layout} vs world 1", _moment_atol(layout))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_trajectory_matches_the_jax_mesh(runs, layout):
    states, hist, _ = runs[layout]
    grid = LAYOUTS[layout][1]
    want_state, want_hist = runs["jax"][grid]
    _assert_gan_close(states[0], hist[0], want_state, want_hist,
                      f"{layout} vs JAX {grid}", _moment_atol(layout))


def test_the_model_axis_adds_nothing_to_data_parallelism(runs):
    """(2, 2) against the (2, 1) data-parallel run of the same rows, at the
    full tolerances."""
    states, hist, _ = runs["tp_2x2"]
    want_states, want_hist, _ = runs["dp_2x1"]
    _assert_gan_close(states[0], hist[0], want_states[0], want_hist[0],
                      "(2, 2) vs (2, 1)")


@pytest.mark.parametrize("layout", [*sorted(LAYOUTS), "fsdp_2x2"])
def test_every_rank_ends_with_the_same_full_state(runs, layout):
    states, _, stats = runs[layout]
    for r, state in enumerate(states[1:], 1):
        for key, value in states[0].items():
            assert np.array_equal(state[key], value), (layout, r, key)
    assert stats[0]["tp_calls_per_step"] > 0


def test_replicated_leaves_get_identical_gradients_on_the_model_ranks(runs):
    """The leaves the rule keeps whole (the discriminators' 1-channel
    outputs, here) are updated by every model rank from its own gradient:
    equal parameters and first moments (``(1 - b1) g`` after one step,
    then linear in the gradients) on every rank, bit for bit."""
    _, models = tiny_setup()
    for layout in ("tp_1x2", "tp_1x4"):
        m = LAYOUTS[layout][0][1]
        replicated = [k for k, a in tp.state_shardings(
            models.discriminator, m).items() if a is None
            and not k.endswith(("weight_u", "weight_v"))]
        assert replicated
        names = [n for n, _ in models.discriminator.named_parameters()]
        states = runs[layout][0]
        for key in replicated:
            idx = names.index(key)
            for r in range(1, m):
                for leaf in (f"discriminator/{key}", f"opt_d/exp_avg/{idx}"):
                    assert np.array_equal(states[r][leaf], states[0][leaf])


def test_hybrid_fsdp_equals_tensor_parallelism_bit_for_bit(runs):
    tp_states, tp_hist, _ = runs["tp_2x2"]
    fs_states, fs_hist, fs_stats = runs["fsdp_2x2"]
    assert [(h["G"], h["D"]) for h in fs_hist[0]] == [
        (h["G"], h["D"]) for h in tp_hist[0]]
    for key, value in tp_states[0].items():
        assert np.array_equal(fs_states[0][key], value), key
    # Each rank holds about a quarter of world 1's state.
    world_one = runs["one"][2]["persistent_bytes"]
    assert fs_stats[0]["persistent_bytes"] < 0.3 * world_one


def test_a_recovery_point_resumes_under_hybrid_fsdp(runs):
    """The worker's recovery points hold the full state: the (1, 2) run's
    step-2 point, restored at (1, 2) with ``--fsdp`` (one data rank: the
    same arithmetic), redoes step 3 bit for bit."""
    states, hist, _ = runs["tp_1x2"]
    got_states, got_hist, _ = runs["tp_1x2_recovered"]
    assert [h["step"] for h in got_hist[0]] == [2]
    assert (got_hist[0][0]["G"], got_hist[0][0]["D"]) == (
        hist[0][2]["G"], hist[0][2]["D"])
    for key, value in states[0].items():
        assert np.array_equal(got_states[0][key], value), key


def test_each_model_rank_holds_its_share_of_the_state(runs):
    world_one = runs["one"][2]["persistent_bytes"]
    for layout, share in (("tp_1x2", 2), ("tp_1x4", 4)):
        held = runs[layout][2][0]["persistent_bytes"]
        assert world_one / share < held < 1.1 * world_one / share, layout


# ---------------------------------------------------------------------------
# The GAN trainer CLI
# ---------------------------------------------------------------------------


def _assert_logged_close(got, want, keys, what):
    assert keys
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {key}")


def test_the_trainer_at_model_parallel_two_logs_what_one_rank_logs(runs):
    want, got = _logged(runs["gan_one"]), _logged(runs["gan_tp"])
    assert got.keys() == want.keys()
    assert {s for t, s in want if t == "train_loss/generator"} == {0, 1, 2, 3}
    _assert_logged_close(got, want, list(want), "(1, 2) vs world 1")
    for entry in (".done", "checkpoint-00000002", "checkpoint-final",
                  "best"):
        assert (runs["gan_tp"] / entry).exists(), entry
    one = torch.load(runs["gan_one"] / "checkpoint-final" / "state.pt",
                     weights_only=True)
    two = torch.load(runs["gan_tp"] / "checkpoint-final" / "state.pt",
                     weights_only=True)
    assert flatten_state(one).keys() == flatten_state(two).keys()


@pytest.mark.parametrize("resume", ["resume_one", "resume_dp"])
def test_a_tensor_parallel_checkpoint_resumes_elsewhere(runs, resume):
    """At world 1 and at (2, 1): step 3 as the uninterrupted (1, 2) run
    logged it."""
    got, want = _logged(runs[resume]), _logged(runs["gan_tp"])
    assert {s for t, s in got if t == "train_loss/generator"} == {3}
    keys = [k for k in got if k[0].startswith("train_loss/")
            and "accuracy" not in k[0]]
    _assert_logged_close(got, want, keys, resume)


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------


def _feeds_batch_norm(key):
    parts = key.split(".")
    return (parts[0] == "conv_blocks" and parts[-1] == "bias"
            and parts[2] in ("conv1", "conv2", "residual_path"))


@pytest.mark.parametrize("want_name", ["jax", "one"])
def test_encoder_steps_at_model_parallel_match(runs, want_name):
    got_losses, got_sd = runs["enc"]["tp"]
    want_losses, want_sd = runs["enc"][want_name]
    np.testing.assert_allclose(got_losses, want_losses, **ENC_TOL)
    assert set(got_sd) == set(want_sd)
    lr_sum = sum(tenc.warmup_lr(i, warmup=2) for i in range(STEPS))
    for key, want in want_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        got = got_sd[key]
        if _feeds_batch_norm(key):
            assert np.abs(got - want).max() <= 2 * lr_sum, key
            continue
        tol = dict(ENC_TOL)
        if key.endswith("running_mean"):
            tol["atol"] += 0.1 * STEPS * 2 * lr_sum
        np.testing.assert_allclose(got, want, **tol, err_msg=key)


def test_the_encoder_cli_at_model_parallel_two_logs_what_one_rank_logs(runs):
    one, two = runs["enc_cli"]
    want, got = _logged(one, ("train", "val")), _logged(two, ("train", "val"))
    assert got.keys() == want.keys()
    assert {"train/loss", "val/loss"} <= {t for t, _ in want}
    _assert_logged_close(got, want, list(want), "encoder (1, 2) vs world 1")
    full = torch.load(one / "last_model.pt", weights_only=True)
    split = torch.load(two / "last_model.pt", weights_only=True)
    assert {k: v.shape for k, v in split.items()} == {
        k: v.shape for k, v in full.items()}


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_what_cannot_run_raises(runs):
    cfg = Config()
    cfg.train.model_parallel = 2
    with pytest.raises(ValueError, match="3 rank"):
        ttrain._check_parallel(cfg, 3)
    cfg.train.batch_size = 6
    with pytest.raises(ValueError, match="do not divide"):
        ttrain._check_parallel(cfg, 8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tenc._check_parallel(data_parallel=-1, model_parallel=2,
                             pipeline_stages=2, size=2)
    assert tenc._check_parallel(-1, 2, 1, size=4) == (2, 2)
    # An MoE encoder at model parallelism above 1 splits its experts over
    # the model ranks (tests/test_torch_expert_parallel.py); pipelined it
    # raises, as in JAX.
    moe = TEnc(**dict(ENC_KW, moe_experts=4))
    with pytest.raises(NotImplementedError, match="MoE"):
        moe.pipelined(torch.zeros(2, 400, 8), pp.StageMesh(
            None, None, None, num_stages=2), 2)
