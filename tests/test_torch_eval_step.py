"""The port's eval step against the JAX package's ``make_eval_step``, f32
on the CPU: every ``val/*`` metric within rtol 1e-4 (atol 1e-6) and every
counter equal, on the live generator weights and on the EMA weights.

The JAX state comes from ``init_state`` with an EMA that differs from the
live weights; ``interop.train_state_from_jax`` carries both into the port.
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

GEN_KW = dict(num_sessions=4, channels=32)
DISC_KW = dict(num_multi_pool=1, num_multi_scale=1,
               period_spec_override=((8, 3, 1, 2),),
               scale_spec_override=((8, 15, 1, 1, 7), (16, 9, 2, 4, 4)))
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps parallel test workers off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(cfg):
    cfg.train.chunk_size = 512
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.model.params = {"channels": 32}
    cfg.data.num_emg_sessions = 4
    return cfg


def _batch(seed=3, b=5):
    rng = np.random.default_rng(seed)
    frames = 512 // C.HOPSIZE
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
def both():
    jmodels = jgan.GANModels(JGen(**GEN_KW), JDisc(**DISC_KW), JEnc(**ENC_KW))
    enc_vars = jmodels.encoder.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 512, 8)), train=False)
    jstate = jgan.init_state(_tiny(JConfig()), jmodels, jax.random.PRNGKey(0))
    # An EMA away from the live weights, so the two evaluations differ.
    noise = jax.random.PRNGKey(5)
    jstate = jstate.replace(gen_ema=jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(noise, p.shape), jstate.gen_params))
    jeval = jax.jit(jgan.make_eval_step(_tiny(JConfig()), jmodels))

    tcfg = _tiny(TConfig())
    tmodels = tgan.GANModels(TGen(**GEN_KW), TDisc(**DISC_KW), TEnc(**ENC_KW))
    interop.load_encoder(tmodels.encoder, enc_vars)
    tmodels.encoder.eval().requires_grad_(False)
    tstate = tgan.init_state(tcfg, tmodels)
    interop.train_state_from_jax(jstate, tmodels, tstate)
    teval = tgan.make_eval_step(tcfg, tmodels)
    return jstate, jeval, enc_vars, tmodels, tstate, teval


def _assert_same(got, want):
    assert set(got) == set(want)
    assert {k for k in want if k.startswith("val/")} == {
        "val/waveform", "val/envelope_l1", "val/multi_td", "val/speech_unit",
        "val/phoneme"}
    for key, w in want.items():
        if key.startswith("count/"):
            assert int(got[key]) == int(w), key
        else:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("weights", ["live", "ema"])
def test_eval_step_matches_jax(both, weights):
    jstate, jeval, enc_vars, tmodels, tstate, teval = both
    batch = _batch()
    jparams = (jstate.gen_params if weights == "live"
               else jgan.eval_generator_params(jstate))
    want = jeval(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                 enc_vars)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if weights == "live":
        got = teval(tbatch)
    else:
        with tgan.eval_generator_params(tmodels, tstate):
            got = teval(tbatch)
    _assert_same(got, want)


def test_eval_generator_params_restores_the_live_weights(both):
    _, _, _, tmodels, tstate, teval = both
    params = list(tmodels.generator.parameters())
    before = [p.detach().clone() for p in params]
    ptrs = [p.data_ptr() for p in params]
    with tgan.eval_generator_params(tmodels, tstate) as gen:
        assert gen is tmodels.generator
        for p, e in zip(params, tstate.gen_ema):
            assert torch.equal(p, e)
    assert [p.data_ptr() for p in params] == ptrs
    for p, b in zip(params, before):
        assert torch.equal(p, b)
    # Without an EMA the generator keeps its live weights.
    no_ema = tgan.GANTrainState(step=0, opt_g=tstate.opt_g,
                                opt_d=tstate.opt_d, gen_ema=None)
    with tgan.eval_generator_params(tmodels, no_ema):
        for p, b in zip(params, before):
            assert torch.equal(p, b)


def test_eval_step_updates_nothing(both):
    _, _, _, tmodels, tstate, teval = both
    sd = {k: v.clone() for k, v in tmodels.discriminator.state_dict().items()}
    gd = {k: v.clone() for k, v in tmodels.generator.state_dict().items()}
    out = teval({k: torch.from_numpy(v) for k, v in _batch(seed=4).items()})
    assert all(not v.requires_grad for v in out.values())
    for mod, saved in ((tmodels.discriminator, sd), (tmodels.generator, gd)):
        for k, v in mod.state_dict().items():
            assert torch.equal(v, saved[k]), k
