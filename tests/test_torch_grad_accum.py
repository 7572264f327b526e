"""The port's accumulating and rematerialising train steps against the JAX
step, f32 on the CPU, with the same initial weights and batches.

One parametrised case per (grad_accum, remat): two steps of the port must
equal two steps of the JAX step with the same settings. The JAX step takes
its default XLA grouped conv and optax AdamW, whose state
``interop.train_state_from_jax`` carries over (the Pallas kernels are held
to the port's in ``tests/test_torch_train_step.py``); the port runs its
kernels' plain versions. The tiny models are those of
``tests/test_torch_train_step.py`` with one period and one (spectrally
normalised) scale discriminator, and so are the tolerances: rtol 1e-4 /
atol 1e-6 on losses, rtol 1e-4 / atol 1e-5 on parameters and EMA (a
twentieth of one AdamW step), rtol 1e-4 / atol 1e-6 on the spectral u/v,
counters equal.

The spectral state is where the two forms can part: every microbatch of a
phase must start from the phase's incoming u/v, and a rematerialised block
must not advance the power iteration a second time in its recompute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.models.discriminator import DiscriminatorEnsemble as TDisc
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.models.generator import EMGGeneratorGanTTS as TGen
from ste_gan_torch.train import gan as tgan
from ste_gan_tpu.config import Config as JConfig
from ste_gan_tpu.models.discriminator import DiscriminatorEnsemble as JDisc
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.models.generator import EMGGeneratorGanTTS as JGen
from ste_gan_tpu.train import gan as jgan

TINY_PERIOD_SPEC = ((8, 3, 1, 2), (16, 3, 3, 2))
TINY_SCALE_SPEC = ((8, 15, 1, 1, 7), (16, 9, 2, 4, 4), (32, 9, 2, 8, 4),
                   (32, 5, 1, 1, 2))
GEN_KW = dict(num_sessions=4, channels=32)
DISC_KW = dict(num_multi_pool=1, num_multi_scale=1,
               period_spec_override=TINY_PERIOD_SPEC,
               scale_spec_override=TINY_SCALE_SPEC)
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)
STEPS = 2
CASES = [(2, False), (2, True), (1, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps parallel test workers off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(cfg, accum, remat):
    cfg.train.chunk_size = 512
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.train.grad_accum = accum
    cfg.train.remat = remat
    cfg.model.params = {"channels": 32}
    cfg.data.num_emg_sessions = 4
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    b, frames = 4, 512 // C.HOPSIZE
    return {
        C.DataType.REAL_EMG: np.tanh(rng.normal(0, 0.4, (b, 512, 8))).astype(
            np.float32),
        C.DataType.SPEECH_UNITS: rng.normal(size=(b, frames, 256)).astype(
            np.float32),
        C.DataType.PHONEMES: rng.integers(0, C.NUM_PHONEMES,
                                          (b, frames)).astype(np.int32),
        C.DataType.SESSION_INDEX: rng.integers(0, 4, (b,)).astype(np.int32),
        C.DataType.SPEAKING_MODE_INDEX: np.zeros((b,), np.int32),
    }


@pytest.fixture(scope="module")
def start():
    """The JAX models, initial state and encoder variables, shared."""
    jmodels = jgan.GANModels(JGen(**GEN_KW),
                             JDisc(**DISC_KW),
                             JEnc(**ENC_KW))
    enc_vars = jmodels.encoder.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 512, 8)), train=False)
    jstate = jgan.init_state(_tiny(JConfig(), 1, False), jmodels,
                             jax.random.PRNGKey(0))
    return jmodels, jstate, enc_vars


def _port(jstate, enc_vars, accum, remat):
    tcfg = _tiny(TConfig(), accum, remat)
    models = tgan.GANModels(TGen(**GEN_KW), TDisc(**DISC_KW), TEnc(**ENC_KW))
    interop.load_encoder(models.encoder, enc_vars)
    models.encoder.eval().requires_grad_(False)
    state = tgan.init_state(tcfg, models)
    interop.train_state_from_jax(jstate, models, state)
    return models, state, tgan.make_train_step(tcfg, models)


def _run_port(start, accum, remat):
    _, jstate, enc_vars = start
    models, state, step = _port(jstate, enc_vars, accum, remat)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in _batch(10 + i).items()})
        metrics.append({k: v.numpy() for k, v in m.items()})
    return models, state, metrics


def _close(got, want, atol, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=atol,
                                   err_msg=f"{what} {key}")


def _assert_metrics(got, want):
    for i, (tm, jm) in enumerate(zip(got, want)):
        assert set(tm) == set(jm)
        for key in jm:
            if key.startswith("count/"):
                assert int(tm[key]) == int(jm[key]), (i, key)
            else:
                np.testing.assert_allclose(tm[key], np.asarray(jm[key]),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{i} {key}")


def _assert_state(models, state, jstate):
    """Generator, EMA, discriminator and its spectral state of the port
    against the JAX state's."""
    gen_params, gen_ema = jstate.gen_params, jstate.gen_ema
    disc_params, spectral = jstate.disc_params, jstate.disc_spectral
    sft = C.DataType.SPEECH_UNITS
    _close(models.generator.state_dict(),
           interop.generator_params_to_state_dict(gen_params, sft), 1e-5,
           "generator")
    names = [n for n, _ in models.generator.named_parameters()]
    _close(dict(zip(names, state.gen_ema)),
           interop.generator_params_to_state_dict(gen_ema, sft), 1e-5, "ema")
    params = dict(models.discriminator.named_parameters())
    want = interop.discriminator_params_to_state_dict(disc_params, spectral)
    _close(params, {k: want[k] for k in params}, 1e-5, "discriminator")
    got_spec = interop.spectral_to_jax(models.discriminator)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-4, atol=1e-6), got_spec,
        jax.tree.map(np.asarray, spectral))


@pytest.mark.parametrize("accum,remat", CASES)
def test_accumulating_step_matches_jax(start, accum, remat):
    jmodels, jstate, enc_vars = start
    jstep = jax.jit(jgan.make_train_step(_tiny(JConfig(), accum, remat),
                                         jmodels))
    jmetrics = []
    for i in range(STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in _batch(10 + i).items()},
                           enc_vars)
        jmetrics.append(jm)
    models, state, metrics = _run_port(start, accum, remat)
    assert state.step == STEPS
    assert int(state.opt_g.count) == int(state.opt_d.count) == STEPS
    _assert_metrics(metrics, jmetrics)
    _assert_state(models, state, jstate)


def test_port_accumulation_equals_the_full_batch(start):
    """K=2 equals K=1 of the port itself: the average of equal-size
    microbatch gradients is the full-batch gradient, and the power
    iteration does not depend on the batch."""
    full_models, full_state, full_metrics = _run_port(start, 1, False)
    models, state, metrics = _run_port(start, 2, False)
    _assert_metrics(metrics, full_metrics)
    spectral = interop.spectral_to_jax(full_models.discriminator)
    gen = dict(full_models.generator.state_dict())
    names = [n for n, _ in full_models.generator.named_parameters()]
    for got_sd, want_sd in (
            (models.generator.state_dict(), gen),
            (dict(zip(names, state.gen_ema)),
             dict(zip(names, full_state.gen_ema))),
            (models.discriminator.state_dict(),
             full_models.discriminator.state_dict())):
        _close(got_sd, {k: v.numpy() for k, v in want_sd.items()}, 1e-5,
               "K=2 vs K=1")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4,
                                                         atol=1e-6),
                 interop.spectral_to_jax(models.discriminator), spectral)


def test_grad_accum_must_divide_the_batch():
    cfg = _tiny(TConfig(), 3, False)
    models = tgan.GANModels(TGen(**GEN_KW), TDisc(**DISC_KW), TEnc(**ENC_KW))
    with pytest.raises(ValueError, match="must divide"):
        tgan.make_train_step(cfg, models)
