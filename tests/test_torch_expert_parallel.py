"""Expert parallelism of the port (``ste_gan_torch/parallel/
expert_parallel.py``) and the mixture-of-experts block over data ranks
(``models/moe.py``), on spawned CPU gloo ranks (rendezvous through files
under ``tmp_path``), against the JAX package's single-device block and
trainer step and against the port at one rank.

* The block (``tests/test_moe.py``'s sizes: D 16, FF 32, 4 experts, top-2,
  a batch of 4 x 8 tokens) at the ``(data, expert)`` layouts (1, 4),
  (2, 2) and (4, 1) of one spawn of four ranks, at JAX's capacity factor
  1.5 and at 0.5, where picks are dropped: the output, the load-balancing
  loss, the gradients of ``sum(y * cot) + 0.7 aux`` with respect to the
  input and the five parameters (each expert slab gathered over the expert
  group), and the dropped-pick count, against JAX's ``MoEFeedForward`` and
  the port's block at one rank. JAX's own tests tie that block to its
  ``(2, 4)`` mesh (``tests/test_moe.py``: rtol 1e-4 / atol 1e-5); across
  the frameworks the model tolerance holds (``tests/test_model_parity.py``:
  rtol 1e-3 / atol 2e-5), and against the port's one rank JAX's.
* The rule: ``w1`` split on its expert axis, the router whole, an
  indivisible leaf whole, nothing outside ``moe_ffn``.
* Three train steps of the narrow MoE encoder (``tests/test_moe.py``'s
  trajectory: 2 experts, shift pinned, dropout 0) at the 2-rank data layout
  and the 2-rank expert layout, against the port at one rank and the JAX
  step: losses within rtol 1e-4, parameters within rtol 1e-3 and JAX's
  AdamW drift bound, 2 x steps x lr.
* ``train.encoder`` with an MoE config (4 experts, dropout 0.2, a mixed
  corpus) at ``--data_parallel 2`` and ``--model_parallel 2``, one epoch:
  its logged losses within rtol 1e-4 / atol 1e-6 of one rank's (the
  trainer tests' CLI tolerance), the checkpoints in the full layout.
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
import torch.nn as nn
import yaml

from ste_gan_torch import constants as C
from ste_gan_torch import emg_encoder_constants as EC
from ste_gan_torch import interop
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.models.moe import MoEFeedForward as TMoE
from ste_gan_torch.parallel import expert_parallel as ep
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.train import encoder as tenc
from ste_gan_torch.train.encoder_data import fold_encoder_batch
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.models.moe import MoEFeedForward as JMoE
from ste_gan_tpu.train import encoder as jenc

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
TIMEOUT = 240
D, FF, E = 16, 32, 4
PARAMS = ("router", "w1", "b1", "w2", "b2")
FACTORS = {"jax_default": 1.5, "dropping": 0.5}
LAYOUTS = {"d1e4": (1, 4), "d2e2": (2, 2), "d4e1": (4, 1)}
MODEL_TOL = dict(rtol=1e-3, atol=2e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS, SHIFT, MAX_SAMPLES = 3, 5, 8
TRAJ_ENC = dict(model_size=D, num_extra_res_blocks=3, num_transformer_layers=1,
                num_heads=4, dim_feedforward=FF, dropout=0.0, moe_experts=2)
CLI_ENCODER = {"model_size": 32, "num_extra_res_blocks": 3,
               "num_transformer_layers": 1, "num_heads": 4,
               "dim_feedforward": 64, "dropout": 0.2, "moe_experts": 4,
               "moe_top_k": 2}

#: Each of four ranks: the block at every layout and capacity factor; this
#: rank's rows, the input gradient of its rows, the parameters' full
#: gradients, the aux loss and the dropped picks, as ``block_r{r}.npz``.
BLOCK_CODE = r'''
import sys, numpy as np, torch, torch.nn as nn
from ste_gan_torch.models.moe import MoEFeedForward
from ste_gan_torch.parallel import expert_parallel as ep
from ste_gan_torch.parallel import mesh as M
from ste_gan_torch.parallel import tensor_parallel as tp
out, init = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
M.init_distributed("gloo", 120, "cpu", init)
rank = torch.distributed.get_rank()
layouts = {name: ep.create_expert_mesh(d, e)
           for name, (d, e) in ''' + repr(LAYOUTS) + r'''.items()}
data = np.load(f"{out}/block.npz")
res = {}
for factor_name, factor in ''' + repr(FACTORS) + r'''.items():
    for name, layout in layouts.items():
        holder = nn.Module()
        holder.moe_ffn = MoEFeedForward(''' + repr(D) + r''', ''' + repr(E) + r''',
                                        ''' + repr(FF) + r''', 2, factor)
        with torch.no_grad():
            for p in ''' + repr(PARAMS) + r''':
                getattr(holder.moe_ffn, p).copy_(torch.from_numpy(data[p]))
        ep.shard_moe_module_(holder, layout)
        block = holder.moe_ffn
        n = data["x"].shape[0] // layout.data_size
        rows = slice(layout.data_rank * n, (layout.data_rank + 1) * n)
        x = torch.from_numpy(data["x"][rows]).requires_grad_()
        cot = torch.from_numpy(data["cot"][rows])
        y = block(x, train=True, group=layout.data)
        loss = torch.sum(y * cot) + 0.7 * block.aux_loss
        params = [getattr(block, p) for p in ''' + repr(PARAMS) + r''']
        grads = list(torch.autograd.grad(loss, [x] + params))
        M.allreduce_grads_(grads[1:], layout.data, average=False)
        key = f"{factor_name}/{name}"
        res[f"{key}/y"] = y.detach().numpy()
        res[f"{key}/x"] = grads[0].numpy()
        res[f"{key}/aux"] = block.aux_loss.detach().numpy()
        res[f"{key}/dropped"] = block.dropped.numpy()
        res[f"{key}/data_rank"] = np.asarray(layout.data_rank)
        for p, g in zip(''' + repr(PARAMS) + r''', grads[1:]):
            axis = holder.tp_axes[f"moe_ffn.{p}"]
            if axis is not None:
                g = tp._all_gather(g, axis, layout.model)
            res[f"{key}/{p}"] = g.numpy()
np.savez(f"{out}/block_r{rank}.npz", **res)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
'''

#: Each of two ranks: three MoE-encoder steps at the data layout (2, 1)
#: and the expert layout (1, 2) from ``traj_init.pt``; rank 0 saves the
#: losses and the full state dict of each as ``traj_{name}.npz``.
TRAJ_CODE = r'''
import sys, numpy as np, torch
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.parallel import expert_parallel as ep
from ste_gan_torch.parallel import mesh as M
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.train import encoder as tenc
out, init = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
M.init_distributed("gloo", 120, "cpu", init)
tenc.random_shift = lambda rng: ''' + repr(SHIFT) + r'''
batches = np.load(f"{out}/traj_batches.npz")
for name, layout in (("data", tp.create_mesh_2d(2, 1)),
                     ("expert", ep.create_expert_mesh(1, 2))):
    model = EMGEncoderTransformer(**''' + repr(TRAJ_ENC) + r''')
    model.load_state_dict(torch.load(f"{out}/traj_init.pt", weights_only=True))
    ep.shard_moe_module_(model, layout)
    state = tenc.init_train_state(model)
    step = tenc.make_encoder_train_step(model, ''' + repr(MAX_SAMPLES) + r''',
                                        group=layout.data)
    losses, dropped = [], []
    for i in range(''' + repr(STEPS) + r'''):
        batch = {k.split("/", 1)[1]: torch.from_numpy(v)
                 for k, v in batches.items() if k.startswith(f"{i}/")}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        dropped.append(int(model.transformer.layers[0].moe_ffn.dropped))
    sd = tp.gather_state_dict(model, layout)
    if torch.distributed.get_rank() == 0:
        np.savez(f"{out}/traj_{name}.npz", losses=np.asarray(losses),
                 dropped=np.asarray(dropped),
                 **{k: v.numpy() for k, v in sd.items()})
torch.distributed.barrier()
torch.distributed.destroy_process_group()
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


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def _jax_block(params, x, cot, factor):
    jm = JMoE(num_experts=E, dim_feedforward=FF, top_k=2,
              capacity_factor=factor)

    def objective(p, xx):
        y, mutated = jm.apply({"params": p}, xx, mutable=["losses"])
        aux = sum(jax.tree.leaves(mutated["losses"]))
        return jnp.sum(y * cot) + 0.7 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return {"y": np.asarray(y), "aux": float(aux), "x": np.asarray(gx),
            **{p: np.asarray(gp[p]) for p in PARAMS}}


def _port_block(params, x, cot, factor):
    block = TMoE(D, E, FF, 2, factor)
    with torch.no_grad():
        for p in PARAMS:
            getattr(block, p).copy_(torch.from_numpy(np.asarray(params[p])))
    xt = torch.from_numpy(x).requires_grad_()
    y = block(xt, train=True)
    loss = torch.sum(y * torch.from_numpy(cot)) + 0.7 * block.aux_loss
    grads = torch.autograd.grad(loss, [xt] + [getattr(block, p)
                                              for p in PARAMS])
    return {"y": y.detach().numpy(), "aux": float(block.aux_loss),
            "x": grads[0].numpy(), "dropped": int(block.dropped),
            **{p: g.numpy() for p, g in zip(PARAMS, grads[1:])}}


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_block")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 8, D)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    params = jax.device_get(JMoE(num_experts=E, dim_feedforward=FF,
                                 top_k=2).init(jax.random.PRNGKey(0),
                                               jnp.asarray(x))["params"])
    np.savez(tmp / "block.npz", x=x, cot=cot,
             **{p: np.asarray(params[p]) for p in PARAMS})
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        job = pool.submit(_spawn, tmp, "block", 4, lambda rdv: [
            "-c", BLOCK_CODE, str(tmp), rdv])
        want = {name: (_jax_block(params, x, cot, f),
                       _port_block(params, x, cot, f))
                for name, f in FACTORS.items()}
        job.result()
    ranks = [dict(np.load(tmp / f"block_r{r}.npz")) for r in range(4)]
    return want, ranks


def _gathered(ranks, key, what):
    """The data ranks' rows of ``what`` in data-rank order (each data rank
    once)."""
    parts = {}
    for res in ranks:
        d = int(res[f"{key}/data_rank"])
        if d in parts:
            np.testing.assert_array_equal(res[f"{key}/{what}"], parts[d])
        parts[d] = res[f"{key}/{what}"]
    return np.concatenate([parts[d] for d in sorted(parts)])


@pytest.mark.parametrize("factor", list(FACTORS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_split_block_matches_jax_and_one_rank(block, factor, layout):
    want, ranks = block
    jax_want, one = want[factor]
    key = f"{factor}/{layout}"
    for what in ("y", "x"):
        got = _gathered(ranks, key, what)
        np.testing.assert_allclose(got, jax_want[what], **MODEL_TOL,
                                   err_msg=f"{key} {what} vs JAX")
        np.testing.assert_allclose(got, one[what], **JAX_TOL,
                                   err_msg=f"{key} {what} vs one rank")
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{key}/aux"], jax_want["aux"],
                                   **MODEL_TOL)
        np.testing.assert_allclose(res[f"{key}/aux"], one["aux"], **JAX_TOL)
        assert int(res[f"{key}/dropped"]) == one["dropped"]
        for p in PARAMS:
            np.testing.assert_allclose(res[f"{key}/{p}"], jax_want[p],
                                       **MODEL_TOL, err_msg=f"{key} {p} r{r}")
            np.testing.assert_allclose(res[f"{key}/{p}"], one[p], **JAX_TOL,
                                       err_msg=f"{key} {p} r{r}")
    if factor == "dropping":
        assert one["dropped"] > 0


def test_the_rule_splits_experts_and_keeps_the_router_whole():
    holder = nn.Module()
    holder.moe_ffn = TMoE(D, E, FF)
    holder.linear = nn.Linear(4, 4)
    specs = ep.moe_state_shardings(holder, 2)
    assert specs["moe_ffn.w1"] == specs["moe_ffn.b2"] == 0
    assert specs["moe_ffn.router"] is None
    assert specs["linear.weight"] is None
    assert all(v is None for v in ep.moe_state_shardings(holder, 3).values())
    assert ep.is_expert_param("transformer.layers.0.moe_ffn.w2",
                              torch.zeros(4, 8, 2), 4)
    assert not ep.is_expert_param("transformer.layers.0.moe_ffn.router",
                                  torch.zeros(16, 4), 4)
    assert not ep.is_expert_param("transformer.layers.0.moe_ffn.b1",
                                  torch.zeros(4), 4)
    # The tensor-parallel rule takes the expert rule for MoE leaves.
    enc = TEnc(**TRAJ_ENC)
    axes = tp.state_shardings(enc, 2)
    assert axes["transformer.layers.0.moe_ffn.w1"] == 0
    assert axes["transformer.layers.0.moe_ffn.router"] is None
    with pytest.raises(ValueError, match="positive"):
        ep.create_expert_mesh(1, 0)


# ---------------------------------------------------------------------------
# The encoder: three steps, and the CLI
# ---------------------------------------------------------------------------


def _traj_batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        items = [{
            C.DataType.REAL_EMG: rng.normal(size=(fr * 16, 8)).astype(
                np.float32),
            C.DataType.SPEECH_UNITS: rng.normal(size=(fr, 256)).astype(
                np.float32),
            C.DataType.PHONEMES: rng.integers(0, C.NUM_PHONEMES, fr).astype(
                np.int32),
            C.DataType.SPEAKING_MODE_ID: C.SpeakingMode.NORMAL,
        } for fr in (30, 40)]
        out.append(fold_encoder_batch(items, seq_len=50, n_win=8,
                                      max_samples=MAX_SAMPLES).as_dict())
    return out


def _jax_trajectory(variables, batches):
    jm = JEnc(**TRAJ_ENC)
    opt = jenc.make_optimizer()
    state = jenc.EncoderTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=opt.init(variables["params"]))
    step = jax.jit(jenc.make_encoder_train_step(jm, MAX_SAMPLES))
    losses = []
    for i, b in enumerate(batches):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()}, i)
        losses.append(float(metrics["loss"]))
    state = jax.device_get(state)
    return losses, interop.encoder_variables_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats})


def _port_trajectory(init_sd, batches):
    model = TEnc(**TRAJ_ENC)
    model.load_state_dict(init_sd)
    state = tenc.init_train_state(model)
    step = tenc.make_encoder_train_step(model, MAX_SAMPLES)
    losses, dropped = [], []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(np.asarray(v))
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        dropped.append(int(model.transformer.layers[0].moe_ffn.dropped))
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}, \
        dropped


def _cli_files(tmp: Path, root: Path) -> dict:
    files = {}
    for name, content in (
            ("config", {"model_base_dir": str(tmp / "unused")}),
            ("data", {"dataset_root": str(root), "name": "synthetic",
                      "num_emg_sessions": 2, "num_emg_channels": 8}),
            ("encoder", {"type": "EMGEncoderTransformer",
                         "params": CLI_ENCODER})):
        files[name] = tmp / f"{name}.yaml"
        files[name].write_text(yaml.safe_dump(content))
    return files


def _cli_argv(files: dict, exp: Path):
    return ["--config", str(files["config"]), "--data", str(files["data"]),
            "--emg_enc_cfg", str(files["encoder"]), "--exp_dir", str(exp),
            "--include_silent", "--num_epochs", "1", "--max_batch_len",
            "3200", "--warmup_steps", "5", "--transfer_dtype", "float32",
            "--device", "cpu", "--dist_timeout_s", "120"]


def _logged(run: Path) -> dict:
    out = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if not rec["tag"].startswith("perf/"):
            out[(rec["tag"], rec["step"])] = rec["value"]
    return out


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_encoder")
    batches = _traj_batches()
    np.savez(tmp / "traj_batches.npz",
             **{f"{i}/{k}": np.asarray(v) for i, b in enumerate(batches)
                for k, v in b.items()})
    jm = JEnc(**TRAJ_ENC)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 400, 8)), train=False))
    port = TEnc(**TRAJ_ENC)
    interop.load_encoder(port, variables)
    torch.save(port.state_dict(), tmp / "traj_init.pt")
    root = tmp / "mixed"
    generate_synthetic_corpus(root, num_train=10, num_valid=3, num_test=2,
                              num_sessions=2, min_frames=30, max_frames=50,
                              seed=5, silent_fraction=0.4)
    files = _cli_files(tmp, root)

    def cli(name, *flags):
        return _spawn(tmp, name, 2, lambda rdv: [
            "-m", "ste_gan_torch.train.encoder",
            *_cli_argv(files, tmp / name), *flags,
            "--dist_init_method", rdv])

    out = {}
    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        jobs = {"traj": pool.submit(_spawn, tmp, "traj", 2, lambda rdv: [
                    "-c", TRAJ_CODE, str(tmp), rdv]),
                "cli_dp": pool.submit(cli, "cli_dp", "--data_parallel", "2"),
                "cli_mp": pool.submit(cli, "cli_mp", "--model_parallel", "2")}
        monkeypatch = pytest.MonkeyPatch()
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(SHIFT, jnp.int32))
        monkeypatch.setattr(tenc, "random_shift", lambda rng: SHIFT)
        try:
            out["jax"] = _jax_trajectory(variables, batches)
            out["one"] = _port_trajectory(port.state_dict(), batches)
        finally:
            monkeypatch.undo()
        tenc.main(tenc.parse_args(_cli_argv(files, tmp / "cli_one")))
        for job in jobs.values():
            job.result()
    for name in ("data", "expert"):
        saved = dict(np.load(tmp / f"traj_{name}.npz"))
        out[name] = (list(saved.pop("losses")), list(saved.pop("dropped")),
                     saved)
    out["cli"] = {name: next((tmp / name).iterdir())
                  for name in ("cli_one", "cli_dp", "cli_mp")}
    return out


@pytest.mark.parametrize("layout", ["data", "expert"])
def test_the_moe_encoder_trajectory_matches_one_rank_and_jax(encoder, layout):
    losses, dropped, sd = encoder[layout]
    one_losses, one_sd, one_dropped = encoder["one"]
    jax_losses, jax_sd = encoder["jax"]
    assert dropped == one_dropped
    np.testing.assert_allclose(losses, one_losses, rtol=1e-4)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    drift = 2.0 * STEPS * EC.LEARNING_RATE
    assert set(sd) == set(one_sd)
    for key, want in one_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        for ref, what in ((want, "one rank"), (jax_sd[key], "JAX")):
            np.testing.assert_allclose(
                sd[key].astype(np.float64), np.asarray(ref, np.float64),
                rtol=1e-3, atol=drift, err_msg=f"{layout} {key} vs {what}")


@pytest.mark.parametrize("layout", ["cli_dp", "cli_mp"])
def test_the_moe_encoder_cli_over_two_ranks_logs_what_one_rank_logs(
        encoder, layout):
    one, two = encoder["cli"]["cli_one"], encoder["cli"][layout]
    want, got = _logged(one), _logged(two)
    assert got.keys() == want.keys()
    assert {"train/loss", "val/loss"} <= {t for t, _ in want}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{layout} {key}")
    full = torch.load(one / "last_model.pt", weights_only=True)
    split = torch.load(two / "last_model.pt", weights_only=True)
    assert {k: v.shape for k, v in split.items()} == {
        k: v.shape for k, v in full.items()}
    assert any(".moe_ffn.w1" in k for k in split)
