"""The port's generator, discriminator ensemble (paired mode, every fmap of
both halves and the spectral state) and EMG encoder (at 512 and 2048
samples, so both relative-position branches run) against the JAX models
with the same weights, carried by ``ste_gan_torch.interop``.

Tolerance: rtol 1e-3 / atol 2e-5, the repo's model-parity tolerance
(tests/test_model_parity.py), f32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch.models.discriminator import DiscriminatorEnsemble
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_tpu.models import discriminator as jdisc
from ste_gan_tpu.models import emg_encoder as jenc
from ste_gan_tpu.models import generator as jgen

TOL = dict(rtol=1e-3, atol=2e-5)
#: The small ensemble's layer structure (kernel 37, stride 2, groups 4 and
#: 16 in the scale discriminators) at narrow widths.
NARROW_PERIOD_SPEC = ((8, 3, 1, 2), (32, 3, 3, 2), (64, 3, 3, 2))
NARROW_SCALE_SPEC = ((16, 15, 1, 1, 7), (32, 37, 2, 4, 18),
                     (64, 37, 2, 16, 18), (64, 5, 1, 1, 2))


@pytest.mark.parametrize("feature_type,input_dim,factor", [
    (C.DataType.SPEECH_UNITS, 256, 16),
    (C.DataType.MFCCS, 25, 8),
])
def test_generator_matches_jax(feature_type, input_dim, factor):
    rng = np.random.default_rng(0)
    b, t = 2, 12
    feats = rng.normal(size=(b, t, input_dim)).astype(np.float32)
    sess = np.array([1, 3], np.int32)
    mode = np.zeros((b,), np.int32)
    jm = jgen.EMGGeneratorGanTTS(speech_feature_type=feature_type,
                                 speech_input_dim=input_dim, num_sessions=4,
                                 channels=32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                     jnp.asarray(sess), jnp.asarray(mode))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(feats),
                               jnp.asarray(sess), jnp.asarray(mode)))
    assert want.shape == (b, factor * t, 8)

    tm = EMGGeneratorGanTTS(speech_feature_type=feature_type,
                            speech_input_dim=input_dim, num_sessions=4,
                            channels=32)
    interop.load_generator(tm, params, feature_type)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))
    got = tm(torch.from_numpy(feats), torch.from_numpy(sess),
             torch.from_numpy(mode)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paired_ensemble_matches_jax():
    rng = np.random.default_rng(1)
    b, t = 2, 256
    fake = np.tanh(rng.normal(0, 0.4, (b, t, 8))).astype(np.float32)
    real = np.tanh(rng.normal(0, 0.4, (b, t, 8))).astype(np.float32)
    spec = dict(period_spec_override=NARROW_PERIOD_SPEC,
                scale_spec_override=NARROW_SCALE_SPEC)
    jm = jdisc.DiscriminatorEnsemble(**spec)
    var = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(2), jnp.asarray(fake))
    (want_f, want_r), mutated = jax.jit(lambda v, x, y: jm.apply(
        v, x, train=True, pair=y, mutable=["spectral"]))(
        var, jnp.asarray(fake), jnp.asarray(real))

    tm = DiscriminatorEnsemble(**spec)
    interop.load_discriminator(tm, var["params"], var["spectral"])
    tm.train()
    got_f, got_r = tm(torch.from_numpy(fake), pair=torch.from_numpy(real))
    assert len(got_f) == len(want_f) == 8
    for got_side, want_side in ((got_f, want_f), (got_r, want_r)):
        for i, (g_list, w_list) in enumerate(zip(got_side, want_side)):
            assert len(g_list) == len(w_list)
            for j, (g, w) in enumerate(zip(g_list, w_list)):
                np.testing.assert_allclose(
                    g.movedim(1, -1).detach().numpy(), np.asarray(w), **TOL,
                    err_msg=f"sub-discriminator {i} fmap {j}")
    spec = interop.spectral_to_jax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-4, atol=1e-6), spec, mutated["spectral"])


@pytest.mark.parametrize("samples", [512, 2048])
def test_encoder_matches_jax(samples):
    rng = np.random.default_rng(3)
    emg = rng.normal(0, 0.3, (2, samples, 8)).astype(np.float32)
    kw = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=2,
              num_heads=4, dim_feedforward=64, dropout=0.0)
    jm = jenc.EMGEncoderTransformer(**kw)
    var = jm.init(jax.random.PRNGKey(4), jnp.asarray(emg), train=False)
    # Non-trivial running statistics, as a trained encoder has.
    var = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 if "batch_stats" in str(path[0]) else x,
        dict(var))
    want_su, want_ph = jm.apply(var, jnp.asarray(emg), train=False)

    tm = EMGEncoderTransformer(**kw)
    interop.load_encoder(tm, var)
    tm.eval()
    got_su, got_ph = tm(torch.from_numpy(emg))
    assert got_su.shape == (2, samples // 16, 256)
    np.testing.assert_allclose(got_su.detach().numpy(), np.asarray(want_su),
                               **TOL)
    np.testing.assert_allclose(got_ph.detach().numpy(), np.asarray(want_ph),
                               **TOL)
