"""The port's mixture-of-experts encoder against the JAX package's, f32 on
the CPU.

* The block (``ste_gan_torch/models/moe.py``) against
  ``ste_gan_tpu.models.moe.MoEFeedForward`` with the JAX weights: top-2 of 4
  experts at a capacity that drops tokens, at full capacity, one expert
  (which is the dense FFN), and uniform routing (aux loss 1). Outputs, the
  aux loss, and gradients with respect to the input and all five
  parameters, at the repo's model tolerance (tests/test_model_parity.py:
  rtol 1e-3, atol 2e-5). The port dispatches by index; no ``[S, E, C]``
  tensor is ever made.
* The weight bridge for ``transformer_{i}/moe_ffn`` and an eval forward of
  a narrow MoE encoder.
* Three train steps of a narrow MoE encoder (loss with the aux term,
  parameters, BatchNorm statistics, AdamW moments; shift pinned, dropout
  0) against ``ste_gan_tpu.train.encoder.make_encoder_train_step``, as
  tests/test_torch_encoder_step.py does for the dense encoder.
* The encoder CLI with an MoE config on the CPU, voiced and mixed, and its
  ``best_val_loss_model.pt`` loaded strictly by the GAN trainer's frozen
  encoder and by ``EMGDecoder``. Export refuses an MoE encoder, as the JAX
  package's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.models.emg_encoder import init_emg_encoder as t_init
from ste_gan_torch.models.moe import MoEFeedForward as TMoE
from ste_gan_torch.ops.fused_adamw import set_learning_rate
from ste_gan_torch.train import encoder as tenc
from ste_gan_torch.train.encoder_data import fold_encoder_batch
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.models.moe import MoEFeedForward as JMoE
from ste_gan_tpu.train import encoder as jenc

TOL = dict(rtol=1e-3, atol=2e-5)
D, FF = 16, 32
PARAMS = ("router", "w1", "b1", "w2", "b2")
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=2,
              num_heads=4, dim_feedforward=64, dropout=0.0, **MOE)
STEPS, MAX_SAMPLES, WARMUP, SHIFT = 3, 8, 2, 5

# (experts, top_k, capacity factor, zero router)
CASES = {"top2_of_4_dropping": (4, 2, 0.5, False),
         "full_capacity": (4, 2, 1e9, False),
         "one_expert_is_dense": (1, 1, 1e9, False),
         "uniform_routing": (4, 2, 1.5, True)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block_case(name, seed=0):
    e, k, cf, uniform = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    cot = rng.normal(size=(2, 12, D)).astype(np.float32)
    jm = JMoE(num_experts=e, dim_feedforward=FF, top_k=k, capacity_factor=cf)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x))["params"])
    if uniform:
        params["router"] = np.zeros_like(params["router"])
    tm = TMoE(D, e, FF, k, cf)
    with torch.no_grad():
        for n in PARAMS:
            getattr(tm, n).copy_(torch.from_numpy(np.array(params[n])))
    return jm, params, tm, x, cot


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_jax(name):
    """Output, aux loss and the gradients of ``sum(y * cot) + 0.7 aux``
    with respect to the input and the five parameters."""
    jm, params, tm, x, cot = _block_case(name)

    def objective(p, xx):
        y, mutated = jm.apply({"params": p}, xx, mutable=["losses"])
        aux = sum(jax.tree.leaves(mutated["losses"]))
        return jnp.sum(y * cot) + 0.7 * aux, (y, aux)

    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    got_y = tm(xt, train=True)
    got_aux = tm.aux_loss
    (torch.sum(got_y * torch.from_numpy(cot)) + 0.7 * got_aux).backward()

    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux.detach()), float(want_aux), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **TOL)
    for n in PARAMS:
        np.testing.assert_allclose(getattr(tm, n).grad.numpy(),
                                   np.asarray(want_gp[n]), **TOL, err_msg=n)

    if name == "top2_of_4_dropping":
        # Some picks are over capacity: their tokens' outputs lose a term.
        assert tm.capacity(24) == 6 < 24
    if name == "uniform_routing":
        np.testing.assert_allclose(float(got_aux.detach()), 1.0, rtol=1e-6)
    if name == "one_expert_is_dense":
        w1, b1 = params["w1"][0], params["b1"][0]
        w2, b2 = params["w2"][0], params["b2"][0]
        dense = np.maximum(x @ w1 + b1, 0.0) @ w2 + b2
        np.testing.assert_allclose(got_y.detach().numpy(), dense, **TOL)


def test_eval_forward_records_no_aux_loss():
    _, _, tm, x, _ = _block_case("full_capacity")
    tm(torch.from_numpy(x))
    assert tm.aux_loss is None


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree.leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_dispatch_makes_no_token_expert_slot_tensor():
    """Forward and backward at 512 tokens, 4 experts, capacity 384: no
    tensor of the [S, E, C] one-hot dispatch (786,432 values) or of its
    size is ever made."""
    s, e = 512, 4
    tm = TMoE(D, e, FF, 2, 1.5, generator=torch.Generator().manual_seed(0))
    cap = tm.capacity(s)
    x = torch.randn(2, s // 2, D, requires_grad=True)
    with _Shapes() as probe:
        y = tm(x, train=True)
        (y.sum() + tm.aux_loss).backward()
    biggest = max(int(np.prod(shape)) for shape in probe.shapes)
    assert cap == 384 and biggest < s * e * cap // 8, biggest
    assert (s, e, cap) not in probe.shapes


def _jax_encoder(emg, seed=4):
    jm = JEnc(**ENC_KW)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(emg), train=False)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.01 if path[-1].key == "var" else x + 0.1,
        variables["batch_stats"])
    return jm, variables["params"], stats


def test_bridge_and_eval_forward_match_jax():
    emg = np.tanh(np.random.default_rng(1).normal(
        0, 0.5, (2, 1600, 8))).astype(np.float32)
    jm, params, stats = _jax_encoder(emg)
    sd = interop.encoder_variables_to_state_dict(
        {"params": params, "batch_stats": stats})
    moe_keys = sorted(k for k in sd if ".moe_ffn." in k)
    assert moe_keys == sorted(f"transformer.layers.{i}.moe_ffn.{n}"
                              for i in range(2) for n in PARAMS)
    assert not any("linear1" in k or "linear2" in k for k in sd)
    tm = TEnc(**ENC_KW)
    interop.load_encoder(tm, {"params": params, "batch_stats": stats})
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(emg))
    with torch.no_grad():
        got = tm(torch.from_numpy(emg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _batch(seed):
    rng = np.random.default_rng(seed)
    items = []
    for frames in (50, 80, 30):
        items.append({
            C.DataType.REAL_EMG: np.tanh(rng.normal(
                0, 0.5, (frames * 16, 8))).astype(np.float32),
            C.DataType.SPEECH_UNITS: rng.normal(
                size=(frames, 256)).astype(np.float32),
            C.DataType.PHONEMES: rng.integers(0, 48, frames).astype(np.int32),
            C.DataType.SPEAKING_MODE_ID: C.SpeakingMode.NORMAL})
    return fold_encoder_batch(items, n_win=2,
                              max_samples=MAX_SAMPLES).as_dict()


@pytest.fixture(scope="module")
def trajectory():
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(SHIFT, jnp.int32))
    monkeypatch.setattr(tenc, "random_shift", lambda rng: SHIFT)
    try:
        batches = [_batch(30 + i) for i in range(STEPS)]
        jm, params, stats = _jax_encoder(batches[0]["emg_windows"])
        opt = jenc.make_optimizer()
        jstate = jenc.EncoderTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=opt.init(params))
        jstep = jax.jit(jenc.make_encoder_train_step(jm, MAX_SAMPLES))
        tm = TEnc(**ENC_KW)
        tstate = tenc.init_train_state(tm)
        interop.encoder_train_state_from_jax(jstate, tm, tstate)
        tstep = tenc.make_encoder_train_step(tm, MAX_SAMPLES)
        jlog, tlog = [], []
        for i, batch in enumerate(batches):
            lr = tenc.warmup_lr(i, warmup=WARMUP)
            jstate.opt_state.hyperparams["learning_rate"] = np.float32(lr)
            jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, i)
            set_learning_rate(tstate.opt, lr)
            tstate, tmet = tstep(tstate, {k: torch.from_numpy(np.asarray(v))
                                          for k, v in batch.items()})
            jlog.append({k: np.asarray(v) for k, v in jmet.items()})
            tlog.append({k: v.numpy() for k, v in tmet.items()})
    finally:
        monkeypatch.undo()
    return jstate, jlog, tm, tstate, tlog


def test_trajectory_losses_include_the_aux_term(trajectory):
    _, jlog, tm, _, tlog = trajectory
    for i, (j, t) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(t["loss"], j["loss"], **TOL, err_msg=str(i))
        for key in ("num_correct", "num_frames"):
            assert int(t[key]) == int(j[key]), (i, key)
    # The step collected (and cleared) every block's aux loss.
    assert all(layer.moe_ffn.aux_loss is None
               for layer in tm.transformer.layers)


def _feeds_batch_norm(key):
    parts = key.split(".")
    return (parts[0] == "conv_blocks" and parts[-1] == "bias"
            and parts[2] in ("conv1", "conv2", "residual_path"))


def test_trajectory_params_and_moments(trajectory):
    """Parameters and BatchNorm statistics (conv biases that feed a
    BatchNorm have a zero gradient and move by rounding noise, held as in
    tests/test_torch_encoder_step.py), then the AdamW moments, MoE
    weights included."""
    jstate, _, tm, tstate, _ = trajectory
    want = interop.encoder_variables_to_state_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = tm.state_dict()
    assert set(got) == set(want)
    lr_sum = sum(tenc.warmup_lr(i, warmup=WARMUP) for i in range(STEPS))
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if _feeds_batch_norm(key):
            assert np.abs(got[key].numpy() - value).max() <= 2 * lr_sum, key
            continue
        tol = dict(TOL)
        if key.endswith("running_mean"):
            tol["atol"] += 0.1 * STEPS * 2 * lr_sum
        np.testing.assert_allclose(got[key].numpy(), value, **tol,
                                   err_msg=key)
    mu, nu, count, _ = interop._adam_inner(jstate.opt_state)
    assert int(tstate.opt.count) == count == STEPS
    names = [n for n, _ in tm.named_parameters()]
    assert sum(".moe_ffn." in n for n in names) == 10
    for moments, tree in ((tstate.opt.exp_avg, mu), (tstate.opt.exp_avg_sq, nu)):
        want_m = interop.encoder_variables_to_state_dict(
            {"params": tree, "batch_stats": jstate.batch_stats})
        for name, value in zip(names, moments):
            np.testing.assert_allclose(value.numpy(), want_m[name], rtol=1e-3,
                                       atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The encoder CLI on the CPU with a narrow MoE config, voiced and
    mixed, one epoch each."""
    tmp = tmp_path_factory.mktemp("moe_cli")
    encoder_yaml = tmp / "encoder.yaml"
    encoder_yaml.write_text(yaml.safe_dump(
        {"type": "EMGEncoderTransformer", "params": dict(ENC_KW)}))
    runs = {}
    for mode, fraction in (("voiced", 0.0), ("mixed", 0.4)):
        root = tmp / mode / "synthetic"
        generate_synthetic_corpus(root, num_train=8, num_valid=3, num_test=2,
                                  num_sessions=2, min_frames=30, max_frames=50,
                                  seed=6, silent_fraction=fraction)
        data_yaml = tmp / f"data_{mode}.yaml"
        data_yaml.write_text(yaml.safe_dump(
            {"dataset_root": str(root), "name": "synthetic",
             "num_emg_sessions": 2, "num_emg_channels": 8}))
        argv = ["--data", str(data_yaml), "--emg_enc_cfg", str(encoder_yaml),
                "--exp_dir", str(tmp / "exp"), "--num_epochs", "1",
                "--max_batch_len", "3200", "--warmup_steps", "5",
                "--transfer_dtype", "float32", "--device", "cpu"]
        suffix = "_voiced_only"
        if mode == "mixed":
            argv.append("--include_silent")
            suffix = "_mixed"
        tenc.main(tenc.parse_args(argv))
        runs[mode] = tmp / "exp" / tenc.create_output_dir_name(
            root, "EMGEncoderTransformer" + suffix)
    return encoder_yaml, runs


@pytest.mark.parametrize("mode", ["voiced", "mixed"])
def test_moe_checkpoint_loads_into_gan_trainer_and_decoder(moe_runs, mode):
    from ste_gan_torch.config import load_config
    from ste_gan_torch.infer import EMGDecoder
    from ste_gan_torch.train import gan as tgan
    from ste_gan_torch.train.train_gan import load_frozen_encoder

    encoder_yaml, runs = moe_runs
    run = runs[mode]
    for entry in (".done", "best_val_loss_model.pt", "last_model.pt"):
        assert (run / entry).exists(), entry
    logged = [line for line in (run / "metrics.jsonl").read_text().splitlines()
              if '"train/loss"' in line]
    assert logged and all(np.isfinite(float(line.split('"value": ')[1]
                                            .split(",")[0].rstrip("}")))
                          for line in logged)
    best = run / "best_val_loss_model.pt"
    state = torch.load(best, weights_only=True)
    assert any(".moe_ffn.w1" in k for k in state)

    cfg = load_config(emg_enc_cfg=str(encoder_yaml))
    cfg.train.mixed_precision = False
    models = tgan.build_models(cfg, device="cpu")
    load_frozen_encoder(models, best)  # strict
    decoder = EMGDecoder.from_checkpoint(cfg, best, device="cpu")  # strict
    saved = t_init(cfg, torch.float32, None)
    saved.load_state_dict(state, strict=True)
    emg = np.tanh(np.random.default_rng(2).normal(
        0, 0.5, (1, 1600, 8))).astype(np.float32)
    with torch.no_grad():
        want = saved(torch.from_numpy(emg))
        got = models.encoder(torch.from_numpy(emg))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    units, _ = decoder.decode(emg[0])
    np.testing.assert_allclose(units, want[0][0].numpy(), rtol=1e-5, atol=1e-6)


def test_export_refuses_an_moe_encoder():
    """Neither package exports an MoE encoder: its capacity is a function
    of the symbolic token count."""
    from ste_gan_torch.export import export_emg_encoder
    from ste_gan_torch.quant import export_emg_encoder_quantized
    from ste_gan_tpu import export as jexport

    tm = TEnc(**dict(ENC_KW, relative_positional_distance=8))
    for fn in (export_emg_encoder, export_emg_encoder_quantized):
        with pytest.raises(NotImplementedError, match="mixture-of-experts"):
            fn(tm, 8)
    jm = JEnc(**dict(ENC_KW, relative_positional_distance=8))
    variables = jm.init(jax.random.PRNGKey(0), np.zeros((1, 256, 8),
                                                        np.float32))
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jexport.export_emg_encoder(jm, variables, 8)


def test_config_builds_the_shipped_moe_encoder():
    from ste_gan_torch.config import load_config

    cfg = load_config(emg_enc_cfg="configs/emg_encoder/conv_transformer_moe.yaml")
    with torch.device("meta"):
        model = t_init(cfg, torch.float32)
    layers = model.transformer.layers
    assert len(layers) == 6 and all(l.moe_ffn is not None for l in layers)
    assert tuple(layers[0].moe_ffn.w1.shape) == (4, 768, 3072)
    assert layers[0].moe_ffn.top_k == 2
    assert layers[0].moe_ffn.capacity(8000) == 6000
