"""The port's encoder pre-training step against the JAX package's, f32 on
the CPU, with the same initial state (carried by
``interop.encoder_train_state_from_jax``) and the same folded batches.

JAX's shift and dropout streams cannot be reproduced in torch, so both
sides pin the shift (``jax.random.randint`` is patched to return it; the
port's ``random_shift`` likewise) and run with dropout 0; the shift itself
is held at r in {0, 3, 7}, and the port's dropout on its own.

Tolerances (the repo's model parity, tests/test_model_parity.py):
rtol 1e-3 / atol 2e-5 for outputs, losses, parameters, BatchNorm
statistics and AdamW moments; counters equal. The train-mode BatchNorm
follows flax (biased variance in the running update); torch's own train
mode would miss the updated ``running_var`` by n/(n-1).

The conv biases that feed a BatchNorm have a zero gradient (the batch mean
removes them), so both packages see rounding noise there, which AdamW
scales up to steps of size lr with arbitrary signs. Those biases are held
to moving by at most one full step per update on each side, and the
running means they feed (each update adds 0.1 x the batch mean, bias
included) to that drift's share on top of the stated tolerance; their
moments, and the running variances, stay within the stated tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.ops.fused_adamw import set_learning_rate
from ste_gan_torch.train import encoder as tenc
from ste_gan_torch.train.encoder_data import fold_encoder_batch
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.train import encoder as jenc

TOL = dict(rtol=1e-3, atol=2e-5)
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)
STEPS = 3
MAX_SAMPLES = 8
WARMUP = 2
SILENT = dict(max_silent=3, silent_target_frames=64, silent_pred_frames=70)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pin_shift(monkeypatch, r):
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(r, jnp.int32))
    monkeypatch.setattr(tenc, "random_shift", lambda rng: r)


def _items(seed, mixed):
    """Two voiced utterances, and with ``mixed`` two silent ones whose
    targets (from the 'parallel voiced recording') have other lengths."""
    rng = np.random.default_rng(seed)

    def item(pred_frames, target_frames, silent):
        return {
            C.DataType.REAL_EMG: np.tanh(rng.normal(
                0, 0.5, (pred_frames * 16, 8))).astype(np.float32),
            C.DataType.SPEECH_UNITS: rng.normal(
                size=(target_frames, 256)).astype(np.float32),
            C.DataType.PHONEMES: rng.integers(
                0, 48, target_frames).astype(np.int32),
            C.DataType.SPEAKING_MODE_ID: (C.SpeakingMode.SILENT if silent
                                          else C.SpeakingMode.NORMAL),
        }

    if not mixed:
        return [item(50, 50, False), item(80, 80, False), item(30, 30, False)]
    return [item(50, 50, False), item(60, 45, True), item(30, 30, False),
            item(40, 55, True)]


def _batch(seed, mixed):
    kw = SILENT if mixed else {}
    return fold_encoder_batch(_items(seed, mixed), n_win=2,
                              max_samples=MAX_SAMPLES, **kw).as_dict()


def _jax_init(emg):
    jm = JEnc(**ENC_KW)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(emg), train=False)
    # Non-trivial running statistics, so the update's decay shows; running
    # variances small beside the batch's, so the updated ones are mostly the
    # batch variance and an n/(n-1) error in it shows (n is 200 positions
    # at the last block).
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.01 if path[-1].key == "var" else x + 0.1,
        variables["batch_stats"])
    return jm, variables["params"], stats


@pytest.mark.parametrize("r", [0, 3, 7])
def test_train_forward_matches_jax(monkeypatch, r):
    """Train-mode forward with the shift pinned: outputs and the updated
    BatchNorm statistics."""
    _pin_shift(monkeypatch, r)
    emg = _batch(0, mixed=False)["emg_windows"]
    jm, params, stats = _jax_init(emg)
    (want_su, want_ph), mutated = jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(emg),
        train=True, rngs={"shift": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)},
        mutable=["batch_stats"])

    tm = TEnc(**ENC_KW)
    interop.load_encoder(tm, {"params": params, "batch_stats": stats})
    got_su, got_ph = tm(torch.from_numpy(emg), train=True, shift=r)
    np.testing.assert_allclose(got_su.detach().numpy(), np.asarray(want_su),
                               **TOL)
    np.testing.assert_allclose(got_ph.detach().numpy(), np.asarray(want_ph),
                               **TOL)
    want_sd = interop.encoder_variables_to_state_dict(
        {"params": params, "batch_stats": mutated["batch_stats"]})
    got_sd = tm.state_dict()
    stat_keys = [k for k in want_sd if k.endswith(("running_mean",
                                                   "running_var"))]
    assert stat_keys
    for key in stat_keys:
        np.testing.assert_allclose(got_sd[key].numpy(), want_sd[key], **TOL,
                                   err_msg=key)


def test_shift_moves_windows_left_with_zero_fill():
    x = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    tm = TEnc(**ENC_KW)
    for r in (0, 3, 7):
        # The ResBlocks see the shifted input: compare the first block's
        # input through a hook.
        seen = []
        hook = tm.conv_blocks[0].register_forward_pre_hook(
            lambda mod, args: seen.append(args[0]))
        tm._frontend(x.repeat(1, 1, 3)[..., :8], train=True, shift=r)
        hook.remove()
        got = seen[0].transpose(1, 2)
        want = torch.roll(x.repeat(1, 1, 3)[..., :8], -r, dims=1)
        if r:
            want[:, -r:] = 0
        assert torch.equal(got, want), r


def test_embed_matches_jax():
    emg = _batch(1, mixed=False)["emg_windows"]
    jm, params, stats = _jax_init(emg)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(emg), method="embed")
    tm = TEnc(**ENC_KW)
    interop.load_encoder(tm, {"params": params, "batch_stats": stats})
    got = tm.embed(torch.from_numpy(emg))
    assert got.shape == (2, 100, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_dropout_draws_from_its_generator():
    tm = TEnc(**dict(ENC_KW, dropout=0.5))
    emg = torch.from_numpy(_batch(2, mixed=False)["emg_windows"])
    with pytest.raises(ValueError, match="Generator"):
        tm(emg, train=True)
    runs = [tm(emg, train=True, generator=torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    # Eval ignores the rate: no generator, no masks.
    assert torch.equal(tm(emg)[0], tm(emg)[0])


@pytest.fixture(scope="module", params=["voiced", "mixed"])
def trajectory(request):
    mixed = request.param == "mixed"
    monkeypatch = pytest.MonkeyPatch()
    _pin_shift(monkeypatch, 5)
    try:
        batches = [_batch(20 + i, mixed) for i in range(STEPS)]
        jm, params, stats = _jax_init(batches[0]["emg_windows"])
        opt = jenc.make_optimizer()
        jstate = jenc.EncoderTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=opt.init(params))
        t_pred = SILENT["silent_pred_frames"] if mixed else 0
        jstep = jax.jit(jenc.make_encoder_train_step(
            jm, MAX_SAMPLES, silent_pred_frames=t_pred))

        tm = TEnc(**ENC_KW)
        tstate = tenc.init_train_state(tm)
        interop.encoder_train_state_from_jax(jstate, tm, tstate)
        tstep = tenc.make_encoder_train_step(tm, MAX_SAMPLES,
                                             silent_pred_frames=t_pred)
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


def test_trajectory_losses_and_counters(trajectory):
    _, jlog, _, tstate, tlog = trajectory
    assert tstate.step == STEPS
    for i, (jm, tm) in enumerate(zip(jlog, tlog)):
        assert set(jm) == set(tm) == {"loss", "num_correct", "num_frames"}
        np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL,
                                   err_msg=str(i))
        for key in ("num_correct", "num_frames"):
            assert int(tm[key]) == int(jm[key]), (i, key)


def test_trajectory_params_and_batch_stats(trajectory):
    jstate, _, tm, _, _ = trajectory
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


def _feeds_batch_norm(key):
    parts = key.split(".")
    return (parts[0] == "conv_blocks" and parts[-1] == "bias"
            and parts[2] in ("conv1", "conv2", "residual_path"))


def test_trajectory_adamw_moments(trajectory):
    jstate, _, tm, tstate, _ = trajectory
    mu, nu, count, lr = interop._adam_inner(jstate.opt_state)
    assert int(tstate.opt.count) == count == STEPS
    assert float(tstate.opt.hyper[0]) == pytest.approx(lr, rel=1e-6)
    names = [n for n, _ in tm.named_parameters()]
    for moments, tree in ((tstate.opt.exp_avg, mu),
                          (tstate.opt.exp_avg_sq, nu)):
        want = interop.encoder_variables_to_state_dict(
            {"params": tree, "batch_stats": jstate.batch_stats})
        for name, got in zip(names, moments):
            np.testing.assert_allclose(got.numpy(), want[name], rtol=1e-3,
                                       atol=1e-7, err_msg=name)
