"""The port's encoder pre-training losses against the JAX package's, f32 on
the CPU, on the items of tests/test_silent_train.py (two voiced and two
silent utterances whose targets have other lengths than their prediction
frames) and of tests/test_encoder_training.py (three voiced ones).

Tolerances (those of tests/test_silent_train.py): loss values rtol 1e-4;
gradients with respect to the predictions rtol 1e-3 / atol 1e-5; counters,
confusion and alignments equal. The port aligns with the plain version of
``dtw_alignment_batched`` here, the JAX step with its ``lax`` wavefront.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.ops.dtw import dtw_alignment_batched
from ste_gan_torch.train import encoder as tenc
from ste_gan_torch.train.encoder_data import fold_encoder_batch
from ste_gan_tpu.train import encoder as jenc

FRAMES_PER_WIN = 100


def _mixed_items(rng):
    """tests/test_silent_train.py::_mixed_items."""
    def item(pred_frames, target_frames, silent):
        return {
            C.DataType.REAL_EMG: rng.normal(
                size=(pred_frames * 16, 8)).astype(np.float32),
            C.DataType.SPEECH_UNITS: rng.normal(
                size=(target_frames, 256)).astype(np.float32),
            C.DataType.PHONEMES: rng.integers(0, 48, target_frames).astype(np.int32),
            C.DataType.SPEAKING_MODE_ID: (C.SpeakingMode.SILENT if silent
                                          else C.SpeakingMode.NORMAL),
        }

    return [item(50, 50, False), item(60, 45, True),
            item(30, 30, False), item(40, 55, True)]


def _voiced_items(rng, lengths=(60, 90, 45)):
    return [{
        C.DataType.REAL_EMG: rng.normal(size=(f * 16, 8)).astype(np.float32),
        C.DataType.SPEECH_UNITS: rng.normal(size=(f, 256)).astype(np.float32),
        C.DataType.PHONEMES: rng.integers(0, 48, f).astype(np.int32),
        C.DataType.SPEAKING_MODE_ID: C.SpeakingMode.NORMAL,
    } for f in lengths]


def _preds(rng, n_win):
    total = n_win * FRAMES_PER_WIN
    return (rng.normal(size=(total, 256)).astype(np.float32),
            rng.normal(size=(total, 48)).astype(np.float32))


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def test_voiced_loss_counters_confusion_and_grads(rng):
    batch = fold_encoder_batch(_voiced_items(rng), n_win=8,
                               max_samples=8).as_dict()
    su, ph = _preds(rng, 8)
    jb, tb = _both(batch)

    def jloss(s, p):
        return jenc.voiced_batch_loss(s, p, jb, max_samples=8)[0]

    want, (wg_su, wg_ph) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(su), jnp.asarray(ph))
    _, want_counters, want_conf = jenc.voiced_batch_loss(
        jnp.asarray(su), jnp.asarray(ph), jb, max_samples=8)

    t_su = torch.tensor(su, requires_grad=True)
    t_ph = torch.tensor(ph, requires_grad=True)
    got, counters, conf = tenc.voiced_batch_loss(t_su, t_ph, tb, max_samples=8)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(t_su.grad.numpy(), np.asarray(wg_su),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t_ph.grad.numpy(), np.asarray(wg_ph),
                               rtol=1e-3, atol=1e-5)
    for key in ("num_correct", "num_frames"):
        assert counters[key].dtype == torch.int32
        assert int(counters[key]) == int(want_counters[key]), key
    assert conf.dtype == torch.int32
    np.testing.assert_array_equal(conf.numpy(), np.asarray(want_conf))
    assert int(conf.sum()) == 60 + 90 + 45


@pytest.mark.parametrize("max_silent", [2, 3])
def test_mixed_loss_and_grads(rng, max_silent):
    """The combined training loss of tests/test_silent_train.py: voiced +
    silent sum / number of samples, with an empty slot when max_silent 3."""
    items = _mixed_items(rng)
    batch = fold_encoder_batch(items, n_win=2, max_samples=4,
                               max_silent=max_silent, silent_target_frames=64,
                               silent_pred_frames=70).as_dict()
    su, ph = _preds(rng, 2)
    jb, tb = _both(batch)

    @jax.jit
    def jloss(s, p):
        voiced, _, _ = jenc.voiced_batch_loss(s, p, jb, max_samples=4)
        silent_sum, _ = jenc.silent_batch_loss(s, p, jb, silent_pred_frames=70)
        return voiced + silent_sum / jnp.float32(len(items))

    want, (wg_su, wg_ph) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(su), jnp.asarray(ph))

    t_su = torch.tensor(su, requires_grad=True)
    t_ph = torch.tensor(ph, requires_grad=True)
    voiced, _, _ = tenc.voiced_batch_loss(t_su, t_ph, tb, max_samples=4)
    silent_sum, _ = tenc.silent_batch_loss(t_su, t_ph, tb,
                                           silent_pred_frames=70)
    got = voiced + silent_sum / len(items)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(t_su.grad.numpy(), np.asarray(wg_su),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t_ph.grad.numpy(), np.asarray(wg_ph),
                               rtol=1e-3, atol=1e-5)


def test_silent_counters_and_confusion(rng):
    items = _mixed_items(rng)
    batch = fold_encoder_batch(items, n_win=2, max_samples=4, max_silent=2,
                               silent_target_frames=64,
                               silent_pred_frames=70).as_dict()
    su, ph = _preds(rng, 2)
    jb, tb = _both(batch)
    want_sum, want = jenc.silent_batch_loss(jnp.asarray(su), jnp.asarray(ph),
                                            jb, silent_pred_frames=70)
    confusion = torch.zeros((48, 48), dtype=torch.int64)
    got_sum, got = tenc.silent_batch_loss(torch.from_numpy(su),
                                          torch.from_numpy(ph), tb,
                                          silent_pred_frames=70,
                                          confusion=confusion)
    np.testing.assert_allclose(float(got_sum), float(want_sum), rtol=1e-4)
    for key in ("num_correct_silent", "num_frames_silent"):
        assert int(got[key]) == int(want[key]), key
    assert int(got["num_frames_silent"]) == 45 + 55

    # The confusion gains exactly the silent frames of the JAX package's
    # host-side eval (silent_losses_host on the same items).
    want_conf = np.zeros((48, 48), np.int64)
    loss, correct, total = jenc.silent_losses_host(su, ph, items,
                                                   confusion=want_conf)
    np.testing.assert_array_equal(confusion.numpy(), want_conf)
    assert (int(got["num_correct_silent"]), int(got["num_frames_silent"])) == (
        correct, total)
    np.testing.assert_allclose(float(got_sum), loss, rtol=1e-4)


def _silent_sample_loss(su_pred, ph_pred, su_target, ph_target):
    """One silent utterance's DTW-aligned loss through the port's batched
    silent loss (one slot, starting at frame 0), and its alignment through
    the same costs and ``dtw_alignment_batched``."""
    t_pred, t_target = len(su_pred), len(su_target)
    batch = {"silent_pred_start": torch.zeros(1, dtype=torch.int32),
             "silent_su_targets": su_target[None],
             "silent_ph_targets": ph_target[None],
             "silent_target_len": torch.tensor([t_target], dtype=torch.int32),
             "silent_pred_len": torch.tensor([t_pred], dtype=torch.int32)}
    loss, _ = tenc.silent_batch_loss(su_pred, ph_pred, batch, t_pred)
    costs, _ = tenc._dtw_costs(su_pred[None], ph_pred[None], su_target[None],
                               ph_target[None])
    ends = torch.tensor([[t_target - 1, t_pred - 1]], dtype=torch.int32)
    return loss, dtw_alignment_batched(costs.transpose(1, 2), ends)[0]


def test_silent_sample_loss_matches_jax(rng):
    su_p = rng.normal(size=(40, 256)).astype(np.float32)
    ph_p = rng.normal(size=(40, 48)).astype(np.float32)
    su_t = rng.normal(size=(33, 256)).astype(np.float32)
    ph_t = rng.integers(0, 48, 33).astype(np.int32)
    want, want_align = jenc.silent_sample_loss(
        jnp.asarray(su_p), jnp.asarray(ph_p), jnp.asarray(su_t),
        jnp.asarray(ph_t))
    got, align = _silent_sample_loss(
        torch.from_numpy(su_p), torch.from_numpy(ph_p), torch.from_numpy(su_t),
        torch.from_numpy(ph_t))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_array_equal(align.numpy(), np.asarray(want_align))


def test_schedules_match_jax():
    for i in (0, 1, 9, 499, 500, 10_000):
        assert tenc.warmup_lr(i) == jenc.warmup_lr(i)
        assert tenc.warmup_lr(i, warmup=10) == jenc.warmup_lr(i, warmup=10)
    values = [1.0, 0.9, 0.9, 0.9, 0.9, 0.95, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
              0.5, 0.5]
    t, j = tenc.ReduceLROnPlateau(patience=2), jenc.ReduceLROnPlateau(patience=2)
    for v in values:
        t.step(v)
        j.step(v)
        assert (t.multiplier, t.best, t.num_bad) == (j.multiplier, j.best,
                                                     j.num_bad)
    assert t.multiplier == pytest.approx(0.125)
