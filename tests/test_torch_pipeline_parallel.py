"""Pipeline parallelism of the port (``ste_gan_torch/parallel/
pipeline_parallel.py``, ``EMGEncoderTransformer.pipelined``) on spawned CPU
gloo ranks (rendezvous through files under ``tmp_path``), against the JAX
package's ``pipeline_apply`` and ``pipelined`` on its 8-device CPU mesh and
against the port at one rank.

One spawn of four ranks runs every library case:

* the 4-layer stack of a tiny encoder over a 1-D layout of 4 stages (one
  layer each) at 4 and 8 microbatches, and over the ``(data, stage) =
  (2, 2)`` layout at 4 (two layers a stage): the forward against JAX's
  ``pipeline_apply`` on its 4-stage and ``(2, 4)`` meshes and against the
  port's sequential loop (``tests/test_pipeline_parallel.py``'s rtol 1e-4
  / atol 2e-6), the gradients against the sequential loop's (rtol 1e-4 /
  atol 1e-5 at 1-D, rtol 1e-2 / atol 2e-5 at ``(data, stage)``, that
  file's tolerances) and JAX's (``tests/test_model_parity.py``'s rtol 1e-3
  / atol 2e-5 across the frameworks; rtol 1e-2 at ``(data, stage)``);
* the output's gradient: each stage rank differentiates ``sum(y * cot *
  (s + 1))`` of the replicated output with seed 1; the gradients must be
  those of the last stage's cotangent alone (``4 * cot``), not the sum
  over the stages (``10 * cot``) nor ``S`` times one;
* ``pipelined`` of a narrow encoder (4 layers) in eval mode over the 4
  stages against ``__call__`` at one rank and JAX's ``pipelined`` on a
  2-stage mesh (forward and the gradients of every parameter after
  ``allreduce_stage_grads_``, ``tests/test_model_parity.py``'s rtol 1e-3 /
  atol 2e-5), and in train mode with dropout 0.2 over ``(2, 2)`` at 2
  microbatches against the port's one-device train forward: outputs,
  gradients, BatchNorm running statistics and the generator's state after
  the step (the masks are drawn for the whole batch and sliced).

The trainer (``python -m ste_gan_torch.train.encoder --pipeline_stages``,
dropout 0, shift pinned, the JAX trainer's initial weights): at ``S = 2``
(default microbatches) and at ``(2, 2)`` with 2 microbatches, 2 epochs,
its logged losses against the port at one rank (rtol 1e-4 / atol 1e-6) and
the JAX trainer at one device (``tests/test_encoder_pipeline_trainer.py``'s
rtol 1e-3 / atol 1e-4); its checkpoints in the full reference layout. The
guards: the batch and data-axis rules, the mutually exclusive axes, a
stage count that does not divide the layers, and MoE layers.
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
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.parallel import pipeline_parallel as pp
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.train import encoder as tenc
from ste_gan_tpu.config import Config as JConfig
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.models.emg_encoder import init_emg_encoder as j_init
from ste_gan_tpu.parallel.pipeline_parallel import (
    create_stage_mesh, create_stage_mesh_2d, pipeline_apply,
    stack_stage_params, transformer_stack_layer_fn)
from ste_gan_tpu.train import encoder as jenc

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
TIMEOUT = 240
D_MODEL, HEADS, FF, LAYERS = 32, 4, 64, 4
STACK = dict(model_size=D_MODEL, num_extra_res_blocks=1,
             num_transformer_layers=LAYERS, num_heads=HEADS,
             dim_feedforward=FF, dropout=0.0)
ENC = dict(STACK, num_extra_res_blocks=3)
MODEL_TOL = dict(rtol=1e-3, atol=2e-5)
SHIFT = 3
TRAINER_ENCODER = {"model_size": 32, "num_extra_res_blocks": 3,
                   "num_transformer_layers": 2, "num_heads": 4,
                   "dim_feedforward": 64, "dropout": 0.0}
#: Conv biases followed by a BatchNorm, and the running means they move.
BN_FED = (".conv1.bias", ".conv2.bias", ".residual_path.bias",
          ".running_mean")
TRAINER_RUN = ["--max_batch_len", "6400", "--num_epochs", "2",
               "--warmup_steps", "10", "--transfer_dtype", "float32"]

#: Each of four ranks: every library case of the module docstring, this
#: rank's results saved as ``rank{r}.npz``.
RANK_CODE = r'''
import sys, numpy as np, torch, torch.distributed as dist
import torch.nn.functional as F
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.parallel import mesh as M
from ste_gan_torch.parallel import pipeline_parallel as pp
out, init = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
M.init_distributed("gloo", 120, "cpu", init)
rank = dist.get_rank()
one_d = pp.create_stage_mesh(4)
two_d = pp.create_stage_mesh_2d(2, 2)
x = torch.from_numpy(np.load(f"{out}/x.npy"))
cot = torch.from_numpy(np.load(f"{out}/cot.npy"))
res = {}

def load(kw, name):
    model = EMGEncoderTransformer(**kw)
    model.load_state_dict(torch.load(f"{out}/{name}.pt", weights_only=True))
    return model

def own_grads(model, mesh, grads, prefix):
    """This stage's layer gradients under their state-dict names."""
    _, own = pp.stage_parameters(model, mesh)
    names = {id(p): n for n, p in model.named_parameters()}
    for p, g in zip(own, grads):
        res[f"{prefix}/{names[id(p)]}"] = g.numpy()

def stack_case(name, mesh, m, loss):
    model = load(''' + repr(STACK) + r''', "stack")
    pp.shard_stages_(model, mesh)
    layers = pp.stage_layers(model, mesh.stage_rank, mesh.num_stages)
    params = list(layers.parameters())

    def stage_fn(h, i):
        for layer in layers:
            h = layer(h)
        return h

    y = pp.pipeline_apply(stage_fn, params, x, mesh, m)
    res[f"{name}/y"] = y.detach().numpy()
    if loss is None:
        return
    if loss == "seeded":
        value = pp.last_stage_only(torch.sum(y * y), mesh)
    else:  # every stage rank's own cotangent, seed 1 everywhere
        value = torch.sum(y * cot * (mesh.stage_rank + 1))
    grads = list(torch.autograd.grad(value, params))
    M.allreduce_grads_(grads, mesh.data, average=False)
    own_grads(model, mesh, grads, name)

stack_case("s4_m4", one_d, 4, "seeded")
stack_case("s4_m8", one_d, 8, None)
stack_case("cot", one_d, 4, "every_stage")
stack_case("d2s2_m4", two_d, 4, "seeded")

def encoder_case(name, mesh, m, train, dropout):
    kw = dict(''' + repr(ENC) + r''', dropout=dropout)
    model = load(kw, "enc")
    pp.shard_stages_(model, mesh)
    emg = torch.from_numpy(np.load(f"{out}/emg.npy"))
    gen = torch.Generator().manual_seed(11)
    local = pp.microbatch_rows(emg, m, mesh)
    su, ph = model.pipelined(local, mesh, m, train=train, shift=''' + repr(SHIFT) + r''',
                             generator=gen)
    su = pp.gather_microbatch_rows(su, m, mesh)
    ph = pp.gather_microbatch_rows(ph, m, mesh)
    res[f"{name}/su"], res[f"{name}/ph"] = su.detach().numpy(), ph.detach().numpy()
    loss = torch.sum(su * su) + torch.sum(F.log_softmax(ph, dim=-1))
    replicated, own = pp.stage_parameters(model, mesh)
    grads = list(torch.autograd.grad(pp.last_stage_only(loss, mesh),
                                     replicated + own, materialize_grads=True))
    pp.allreduce_stage_grads_(grads[:len(replicated)], grads[len(replicated):],
                              mesh)
    names = {id(p): n for n, p in model.named_parameters()}
    for p, g in zip(replicated + own, grads):
        res[f"{name}/grad/{names[id(p)]}"] = g.numpy()
    for k, v in model.state_dict().items():
        if "running" in k:
            res[f"{name}/state/{k}"] = v.numpy()
    res[f"{name}/generator"] = gen.get_state().numpy()

encoder_case("enc_eval", one_d, 4, False, 0.0)
encoder_case("enc_train", two_d, 2, True, 0.2)
np.savez(f"{out}/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
'''

#: A trainer rank: the JAX trainer's initial weights (the first argument;
#: "-": the port's seeded ones), the shift pinned, then the CLI with the
#: arguments after the rendezvous.
TRAINER_CODE = r'''
import sys, torch
from ste_gan_torch.train import encoder as tenc
weights, init, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
torch.set_num_threads(1)
factory = tenc.init_emg_encoder

def port_init(cfg, dtype, generator):
    model = factory(cfg, dtype, generator)
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model

if weights != "-":
    tenc.init_emg_encoder = port_init
tenc.random_shift = lambda rng: ''' + repr(SHIFT) + r'''
tenc.main(tenc.parse_args(argv + ["--dist_init_method", init]))
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


def _port_model(kw, jax_variables) -> TEnc:
    model = TEnc(**kw)
    interop.load_encoder(model, jax_variables)
    return model


def _layer_sd(layer_trees) -> dict:
    """Per-layer JAX parameter trees -> state-dict names."""
    return interop.encoder_variables_to_state_dict({"params": {
        f"transformer_{i}": t for i, t in enumerate(layer_trees)}})


def _unstack(stacked) -> list:
    n = jax.tree.leaves(stacked)[0].shape[0]
    return [jax.tree.map(lambda a, i=i: np.asarray(a[i]), stacked)
            for i in range(n)]


# ---------------------------------------------------------------------------
# The library cases
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 12, D_MODEL)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    emg = np.tanh(rng.normal(0, 0.5, (4, 400, 8))).astype(np.float32)
    np.save(tmp / "x.npy", x)
    np.save(tmp / "cot.npy", cot)
    np.save(tmp / "emg.npy", emg)
    jstack = JEnc(**STACK)
    svars = jstack.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 8)),
                        train=False)
    jenc_model = JEnc(**ENC)
    evars = jenc_model.init(jax.random.PRNGKey(2), jnp.asarray(emg[:1]),
                            train=False)
    torch.save(_port_model(STACK, svars).state_dict(), tmp / "stack.pt")
    torch.save(_port_model(ENC, evars).state_dict(), tmp / "enc.pt")
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        job = pool.submit(_spawn, tmp, "ranks", 4, lambda rdv: [
            "-c", RANK_CODE, str(tmp), rdv])
        jax_out = _jax_library(svars, evars, x, emg)
        job.result()
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return {"x": x, "cot": cot, "emg": emg, "svars": svars, "evars": evars,
            "ranks": ranks, "jax": jax_out}


def _jax_library(svars, evars, x, emg) -> dict:
    layer_fn = transformer_stack_layer_fn(D_MODEL, HEADS, FF)
    stacked = stack_stage_params([svars["params"][f"transformer_{i}"]
                                  for i in range(LAYERS)])
    out = {}
    for name, mesh, m in (("s4_m4", create_stage_mesh(4), 4),
                          ("s4_m8", create_stage_mesh(4), 8),
                          ("d2s2_m4", create_stage_mesh_2d(2, 4), 4)):
        fwd = jax.jit(lambda sp, xx, mesh=mesh, m=m: pipeline_apply(
            layer_fn, sp, xx, mesh, m))
        out[f"{name}/y"] = np.asarray(fwd(stacked, jnp.asarray(x)))
        if m == 4:
            grads = jax.jit(jax.grad(lambda sp, mesh=mesh: jnp.sum(jnp.square(
                pipeline_apply(layer_fn, sp, jnp.asarray(x), mesh, 4)))))(
                stacked)
            out[f"{name}/grads"] = _layer_sd(_unstack(grads))

    jm = JEnc(**ENC)
    mesh = create_stage_mesh(2)

    def loss(params, method, *extra):
        su, ph = jm.apply({"params": params,
                           "batch_stats": evars["batch_stats"]},
                          jnp.asarray(emg), *extra, train=False,
                          method=method)
        return jnp.sum(su * su) + jnp.sum(jax.nn.log_softmax(ph)), (su, ph)

    (_, (su, ph)), grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, "pipelined", mesh, 4), has_aux=True))(
        evars["params"])
    out["enc_eval/su"], out["enc_eval/ph"] = np.asarray(su), np.asarray(ph)
    out["enc_eval/grads"] = interop.encoder_variables_to_state_dict(
        {"params": jax.device_get(grads),
         "batch_stats": evars["batch_stats"]})
    return out


def _port_stack(library):
    model = _port_model(STACK, library["svars"])
    return model, list(model.transformer.layers)


def _sequential(layers, x):
    for layer in layers:
        x = layer(x)
    return x


def _rank_grads(ranks, prefix) -> dict:
    out = {}
    for res in ranks:
        for k, v in res.items():
            if k.startswith(prefix + "/transformer"):
                name = k[len(prefix) + 1:]
                if name in out:  # a (data, stage) replica: the same sum
                    np.testing.assert_array_equal(v, out[name], err_msg=k)
                out[name] = v
    return out


@pytest.mark.parametrize("case, m", [("s4_m4", 4), ("s4_m8", 8),
                                     ("d2s2_m4", 4)])
def test_forward_matches_jax_and_the_sequential_loop(library, case, m):
    x = torch.from_numpy(library["x"])
    _, layers = _port_stack(library)
    mb = x.shape[0] // m
    with torch.no_grad():
        want_mb = torch.cat([_sequential(layers, x[i * mb:(i + 1) * mb])
                             for i in range(m)]).numpy()
        want_full = _sequential(layers, x).numpy()
    for r, res in enumerate(library["ranks"]):
        got = res[f"{case}/y"]
        np.testing.assert_allclose(got, library["jax"][f"{case}/y"],
                                   rtol=1e-4, atol=2e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got, want_mb, rtol=1e-4, atol=2e-6)
        np.testing.assert_allclose(got, want_full, rtol=1e-3, atol=1e-5)
        np.testing.assert_array_equal(got, library["ranks"][0][f"{case}/y"])


@pytest.mark.parametrize("case, tol", [
    ("s4_m4", dict(rtol=1e-4, atol=1e-5)),
    ("d2s2_m4", dict(rtol=1e-2, atol=2e-5))])
def test_gradients_match_the_sequential_loop_and_jax(library, case, tol):
    """Against the port's sequential stack at the JAX test's tolerance for
    the layout; against JAX's pipeline at the model tolerance (at (data,
    stage), the JAX test's looser rtol)."""
    model, layers = _port_stack(library)
    x = torch.from_numpy(library["x"])
    params = [p for layer in layers for p in layer.parameters()]
    grads = torch.autograd.grad(torch.sum(_sequential(layers, x) ** 2),
                                params)
    names = {id(p): n for n, p in model.named_parameters()}
    want = {names[id(p)]: g.numpy() for p, g in zip(params, grads)}
    got = _rank_grads(library["ranks"], case)
    want_jax = library["jax"][f"{case}/grads"]
    assert set(got) == set(want) == set(want_jax)
    jax_tol = dict(MODEL_TOL, rtol=max(MODEL_TOL["rtol"], tol["rtol"]))
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, **tol, err_msg=key)
        np.testing.assert_allclose(got[key], want_jax[key], **jax_tol,
                                   err_msg=key)


def test_only_the_last_stage_cotangent_enters_the_ring(library):
    """Each stage rank's own cotangent, seed 1 on every rank: the stack's
    gradients are those of ``sum(y * 4 cot)``, the last stage's, not of
    the stages' sum (10 cot) or of S times one of them."""
    model, layers = _port_stack(library)
    x = torch.from_numpy(library["x"])
    cot = torch.from_numpy(library["cot"])
    params = [p for layer in layers for p in layer.parameters()]
    mb = x.shape[0] // 4
    y = torch.cat([_sequential(layers, x[i * mb:(i + 1) * mb])
                   for i in range(4)])
    grads = torch.autograd.grad(torch.sum(y * cot * 4), params)
    names = {id(p): n for n, p in model.named_parameters()}
    want = {names[id(p)]: g.numpy() for p, g in zip(params, grads)}
    got = _rank_grads(library["ranks"], "cot")
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-5,
                                   err_msg=key)
        scale = np.abs(value).max()
        if scale > 1e-3:
            assert np.abs(got[key] - 2.5 * value).max() > 0.1 * scale, key


def test_pipelined_encoder_matches_call_and_jax(library):
    """Eval mode over 4 stages: forward and every parameter's gradient
    against ``__call__`` at one rank and JAX's ``pipelined``."""
    model = _port_model(ENC, library["evars"])
    emg = torch.from_numpy(library["emg"])
    su, ph = model(emg)
    loss = torch.sum(su * su) + torch.sum(torch.log_softmax(ph, dim=-1))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want_jax = library["jax"]
    for r, res in enumerate(library["ranks"]):
        np.testing.assert_allclose(res["enc_eval/su"], su.detach().numpy(),
                                   **MODEL_TOL)
        np.testing.assert_allclose(res["enc_eval/ph"], ph.detach().numpy(),
                                   **MODEL_TOL)
        np.testing.assert_allclose(res["enc_eval/su"], want_jax["enc_eval/su"],
                                   **MODEL_TOL)
        np.testing.assert_allclose(res["enc_eval/ph"], want_jax["enc_eval/ph"],
                                   **MODEL_TOL)
        held = {k.split("/", 2)[2]: v for k, v in res.items()
                if k.startswith("enc_eval/grad/")}
        own = {k for k in held if k.startswith(f"transformer.layers.{r}.")}
        layers = {k for k in grads if k.startswith("transformer.layers.")}
        assert set(held) == (set(grads) - layers) | own
        for key, value in held.items():
            np.testing.assert_allclose(value, grads[key].numpy(), **MODEL_TOL,
                                       err_msg=f"rank {r} {key}")
            np.testing.assert_allclose(value, want_jax["enc_eval/grads"][key],
                                       **MODEL_TOL, err_msg=f"rank {r} {key}")


def test_pipelined_dropout_and_batch_norm_equal_one_device(library):
    """Train mode with dropout 0.2 over (data, stage) = (2, 2): the masks
    of one device's forward (drawn for the whole batch, sliced per
    microbatch), BatchNorm over the data group with the running statistics
    moved alike on every rank, and the generator left where one device
    leaves it."""
    model = _port_model(dict(ENC, dropout=0.2), library["evars"])
    emg = torch.from_numpy(library["emg"])
    gen = torch.Generator().manual_seed(11)
    su, ph = model(emg, train=True, shift=SHIFT, generator=gen)
    loss = torch.sum(su * su) + torch.sum(torch.log_softmax(ph, dim=-1))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    stats = {k: v.numpy() for k, v in model.state_dict().items()
             if "running" in k}
    for r, res in enumerate(library["ranks"]):
        np.testing.assert_allclose(res["enc_train/su"], su.detach().numpy(),
                                   **MODEL_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["enc_train/ph"], ph.detach().numpy(),
                                   **MODEL_TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(res["enc_train/generator"],
                                      gen.get_state().numpy())
        for key, value in stats.items():
            np.testing.assert_allclose(res[f"enc_train/state/{key}"], value,
                                       **MODEL_TOL, err_msg=key)
        held = {k.split("/", 2)[2]: v for k, v in res.items()
                if k.startswith("enc_train/grad/")}
        assert held
        for key, value in held.items():
            want = grads[key].numpy()
            # BatchNorm over the data group takes its statistics from
            # all-reduced sums (E[x^2] - E[x]^2) where one device uses
            # var_mean; the convs that feed it see the cancellation, so
            # atol scales with the largest magnitude of the conv's weight
            # gradient (a bias that feeds a BatchNorm has no true
            # gradient: both sides hold rounding).
            scale = grads.get(key.rsplit(".", 1)[0] + ".weight",
                              grads[key]).abs().max()
            atol = MODEL_TOL["atol"] * max(1.0, float(scale))
            np.testing.assert_allclose(value, want, rtol=MODEL_TOL["rtol"],
                                       atol=atol, err_msg=f"rank {r} {key}")


def test_the_guards_raise_as_in_jax():
    mesh = pp.StageMesh(None, None, None, num_stages=4)
    x = torch.zeros(8, 3, 2)
    with pytest.raises(ValueError, match="batch 8 not divisible by "
                                         "num_microbatches 3"):
        pp.pipeline_apply(lambda h, i: h, [], x, mesh, 3)
    mesh2 = pp.StageMesh(None, None, None, data_size=2, num_stages=4)
    with pytest.raises(ValueError, match="microbatch size 1 not divisible "
                                         "by the data axis"):
        pp.pipeline_apply(lambda h, i: h, [], x, mesh2, 8)
    with pytest.raises(ValueError, match="not divisible"):
        pp.stage_layers(TEnc(**dict(STACK, num_transformer_layers=2)), 0, 4)
    with pytest.raises(ValueError, match="launched"):
        pp.create_stage_mesh_2d(2, 2)


def test_moe_layers_are_not_pipelined():
    model = TEnc(**dict(ENC, num_transformer_layers=2, moe_experts=2))
    with pytest.raises(NotImplementedError, match="MoE"):
        model.pipelined(torch.zeros(2, 400, 8),
                        pp.StageMesh(None, None, None, num_stages=2), 2)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def _files(tmp: Path, root: Path, encoder: dict, tag: str) -> dict:
    files = {}
    for name, content in (
            ("config", {"model_base_dir": str(tmp / "unused")}),
            ("data", {"dataset_root": str(root), "name": "synthetic",
                      "num_emg_sessions": 2, "num_emg_channels": 8}),
            ("encoder", {"type": "EMGEncoderTransformer",
                         "params": encoder})):
        files[name] = tmp / f"{name}_{tag}.yaml"
        files[name].write_text(yaml.safe_dump(content))
    return files


def _argv(files: dict, exp: Path, *more):
    return ["--config", str(files["config"]), "--data", str(files["data"]),
            "--emg_enc_cfg", str(files["encoder"]), "--exp_dir", str(exp),
            *TRAINER_RUN, "--device", "cpu", "--dist_timeout_s", "120",
            *more]


def _logged(run: Path) -> dict:
    out = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"] in ("train/loss", "val/loss"):
            out[(rec["tag"], rec["step"])] = rec["value"]
    return out


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_trainer")
    root = tmp / "corpus"
    generate_synthetic_corpus(root, num_train=8, num_valid=2, num_test=2,
                              num_sessions=2, min_frames=110, max_frames=140,
                              seed=5)
    files = _files(tmp, root, TRAINER_ENCODER, "pp")
    bad = _files(tmp, root, dict(TRAINER_ENCODER, num_transformer_layers=1),
                 "one_layer")
    jcfg = JConfig()
    jcfg.emg_encoder.params = dict(TRAINER_ENCODER)
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    jmodel = j_init(jcfg)
    variables = jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 1600, 8)), train=False))(init_rng)
    port = TEnc(**TRAINER_ENCODER)
    interop.load_encoder(port, variables)
    torch.save(port.state_dict(), tmp / "init.pt")

    def ranks(name, world, argv_files, *more, weights=str(tmp / "init.pt")):
        return _spawn(tmp, name, world, lambda rdv: [
            "-c", TRAINER_CODE, weights, rdv,
            *_argv(argv_files, tmp / name, *more)])

    moe = _files(tmp, root, dict(TRAINER_ENCODER, moe_experts=2), "moe")

    def refused(name, argv_files):
        try:
            ranks(name, 2, argv_files, "--pipeline_stages", "2",
                  weights="-")
        except RuntimeError as err:
            return str(err)
        return ""

    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        jobs = {"s2": pool.submit(ranks, "s2", 2, files,
                                  "--pipeline_stages", "2"),
                "d2s2": pool.submit(ranks, "d2s2", 4, files,
                                    "--pipeline_stages", "2",
                                    "--pipeline_microbatches", "2"),
                "not_divisible": pool.submit(refused, "not_divisible", bad),
                "moe": pool.submit(refused, "moe", moe)}
        monkeypatch = pytest.MonkeyPatch()
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(SHIFT, jnp.int32))
        monkeypatch.setattr(tenc, "random_shift", lambda rng: SHIFT)
        try:
            train, dev, _ = jenc.init_voiced_datasets(root)
            jenc.train_encoder_model(jcfg, train, dev, tmp / "jax",
                                     max_len=6400, num_epochs=2,
                                     warmup_steps=10,
                                     transfer_dtype="float32")
            factory = tenc.init_emg_encoder

            def port_init(cfg, dtype, generator):
                model = factory(cfg, dtype, generator)
                interop.load_encoder(model, variables)
                return model

            monkeypatch.setattr(tenc, "init_emg_encoder", port_init)
            tenc.main(tenc.parse_args(_argv(files, tmp / "one")))
        finally:
            monkeypatch.undo()
        results = {k: job.result() for k, job in jobs.items()}
    runs = {name: next((tmp / name).iterdir()) for name in ("one", "s2",
                                                             "d2s2")}
    jax_logged = {}
    for line in (tmp / "jax" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"] in ("train/loss", "val/loss"):
            jax_logged[(rec["tag"], rec["step"])] = rec["value"]
    return {"runs": runs, "jax": jax_logged,
            "not_divisible": results["not_divisible"], "moe": results["moe"]}


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
def test_the_pipelined_trainer_logs_what_one_rank_and_jax_log(trainer,
                                                              layout):
    want = _logged(trainer["runs"]["one"])
    got = _logged(trainer["runs"][layout])
    assert got.keys() == want.keys() == trainer["jax"].keys()
    assert {t for t, _ in want} == {"train/loss", "val/loss"}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{layout} {key} vs one rank")
        np.testing.assert_allclose(got[key], trainer["jax"][key], rtol=1e-3,
                                   atol=1e-4, err_msg=f"{layout} {key} vs JAX")


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
def test_the_pipelined_checkpoints_are_whole(trainer, layout):
    run = trainer["runs"][layout]
    for entry in (".done", "best_val_loss_model.pt", "last_model.pt"):
        assert (run / entry).exists(), entry
    want = torch.load(trainer["runs"]["one"] / "last_model.pt",
                      weights_only=True)
    got = torch.load(run / "last_model.pt", weights_only=True)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    TEnc(**TRAINER_ENCODER).load_state_dict(got, strict=True)
    # tests/test_torch_encoder_dp.py's tolerances: the conv biases that
    # feed a BatchNorm (no true gradient) and the running means they move
    # are held to AdamW's drift ceiling, steps x 3e-4.
    steps = max(s for t, s in _logged(trainer["runs"]["one"])
                if t == "train/loss")
    for key, value in want.items():
        atol = steps * 3e-4 if key.endswith(BN_FED) else 1e-5
        np.testing.assert_allclose(got[key].double().numpy(),
                                   value.double().numpy(), rtol=1e-4,
                                   atol=atol, err_msg=key)


def test_the_trainer_guards(trainer):
    with pytest.raises(ValueError, match="mutually exclusive"):
        tenc._check_parallel(-1, 2, 2, size=4)
    with pytest.raises(ValueError, match="pipeline_parallel.py"):
        tenc._check_parallel(-1, 1, 2, size=3)
    with pytest.raises(ValueError, match="pipeline_stages above 1"):
        tenc._check_parallel(-1, 1, 1, pipeline_microbatches=2, size=2)
    assert tenc._check_parallel(-1, 1, 2, size=4) == (2, 1)
    assert "num_transformer_layers 1 not divisible" in trainer["not_divisible"]
    assert "NotImplementedError" in trainer["moe"] and "MoE" in trainer["moe"]
