"""The port's decode direction (``ste_gan_torch.infer.EMGDecoder``) against
the JAX package's on the CPU: the receptive-field bound, full decoding,
streaming that equals the full decode when its context covers the bound and
diverges when it does not, the short-utterance fallback, the length check,
and loading the ``.pt`` that the port's encoder trainer writes.

Weights are made by JAX from a seed and carried across by
``ste_gan_torch.interop``. Tolerances: rtol 1e-3 / atol 2e-5 against JAX
(tests/test_model_parity.py); streaming against the full decode atol 2e-5,
as the JAX package's tests/test_decode.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.infer import EMGDecoder, decoder_receptive_field_frames
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.train.encoder import _save_state_dict
from ste_gan_tpu import infer as jinfer
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEncoder

TOL = dict(rtol=1e-3, atol=2e-5)
DIST = 8
LAYERS = 2
KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=LAYERS,
          num_heads=4, dim_feedforward=64, dropout=0.0,
          relative_positional_distance=DIST)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variables(model, seed):
    return jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 16 * 8, 8)), train=False))(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def decoders():
    jm = JEncoder(**KW)
    variables = _jax_variables(jm, 0)
    tm = EMGEncoderTransformer(**KW)
    interop.load_encoder(tm, variables)
    return jinfer.EMGDecoder(jm, variables), EMGDecoder(tm, device="cpu")


@pytest.fixture(scope="module")
def emg():
    rng = np.random.default_rng(0)
    return np.tanh(rng.normal(0, 0.4, (80 * 16, 8))).astype(np.float32)


def test_receptive_field_bound(decoders):
    jdec, tdec = decoders
    assert (decoder_receptive_field_frames(tdec.model)
            == jinfer.decoder_receptive_field_frames(jdec.model)
            == LAYERS * (DIST - 1) + 2)


def test_decode_matches_jax(decoders, emg):
    jdec, tdec = decoders
    units, ph = tdec.decode(emg)
    want_u, want_p = jdec.decode(emg)
    assert units.shape == (80, 256) and ph.shape == (80, 48)
    np.testing.assert_allclose(units, want_u, **TOL)
    np.testing.assert_allclose(ph, want_p, **TOL)


def test_streaming_equals_full_decode(decoders, emg):
    _, tdec = decoders
    units_full, ph_full = tdec.decode(emg)
    chunks = list(tdec.decode_streaming(emg, chunk_frames=16))
    # 80 frames, chunk 16, context 16: windows of 48 < 80 frames, so the
    # streamed path ran, not the short-utterance fallback.
    assert len(chunks) == 5
    units = np.concatenate([u for u, _ in chunks])
    ph = np.concatenate([p for _, p in chunks])
    np.testing.assert_allclose(units, units_full, atol=2e-5, rtol=0)
    np.testing.assert_allclose(ph, ph_full, atol=2e-5, rtol=0)


def test_insufficient_context_diverges(decoders, emg):
    """Below the dependency bound the chunk edges differ from the full
    decode: the agreement above comes from the context, not from a loose
    tolerance."""
    _, tdec = decoders
    units_full, _ = tdec.decode(emg)
    chunks = list(tdec.decode_streaming(emg, chunk_frames=16,
                                        context_frames=1))
    units = np.concatenate([u for u, _ in chunks])
    assert np.abs(units - units_full).max() > 1e-4


def test_short_utterance_falls_back_to_the_full_decode(decoders):
    _, tdec = decoders
    rng = np.random.default_rng(1)
    short = np.tanh(rng.normal(0, 0.4, (20 * 16, 8))).astype(np.float32)
    units_full, ph_full = tdec.decode(short)
    chunks = list(tdec.decode_streaming(short, chunk_frames=16))
    assert len(chunks) == 2
    np.testing.assert_array_equal(
        np.concatenate([u for u, _ in chunks]), units_full)
    np.testing.assert_array_equal(
        np.concatenate([p for _, p in chunks]), ph_full)


def test_unaligned_lengths_raise(decoders):
    _, tdec = decoders
    with pytest.raises(ValueError, match="multiple of 16"):
        tdec.decode(np.zeros((100, 8), np.float32))
    with pytest.raises(ValueError, match="multiple of 16"):
        next(tdec.decode_streaming(np.zeros((100, 8), np.float32)))


def test_from_checkpoint_loads_the_encoder_trainers_file(tmp_path):
    kw = dict(KW, num_transformer_layers=1)
    jm = JEncoder(**kw)
    variables = _jax_variables(jm, 2)
    cfg = TConfig()
    cfg.emg_encoder.params = dict(kw)
    model = EMGEncoderTransformer(**kw)
    interop.load_encoder(model, variables)
    path = tmp_path / "best_val_loss_model.pt"
    _save_state_dict(model.state_dict(), path)  # the trainer's writer

    dec = EMGDecoder.from_checkpoint(cfg, path, device="cpu")
    assert not dec.model.training
    rng = np.random.default_rng(2)
    emg = np.tanh(rng.normal(0, 0.4, (12 * 16, 8))).astype(np.float32)
    units, ph = dec.decode(emg)
    want_u, want_p = jm.apply(variables, jnp.asarray(emg)[None], train=False)
    np.testing.assert_allclose(units, np.asarray(want_u[0]), **TOL)
    np.testing.assert_allclose(ph, np.asarray(want_p[0]), **TOL)
    assert ph.shape == (12, 48)
