"""The port's encoder batching (``ste_gan_torch/train/encoder_data.py``)
against the JAX package's, bit for bit: the sampler's batches, the host
fold field for field (silent DTW slots included), and the port's on-device
fold (here on the CPU) against both the host fold and the JAX package's
jitted ``EncoderDeviceCorpus.fold``; and the fold's overflow errors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import emg_encoder_constants as TEC
from ste_gan_torch.data.dataset import EMGDataset
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.train import encoder_data as tdata
from ste_gan_tpu import emg_encoder_constants as JEC
from ste_gan_tpu.data.dataset import EMGDataset as JDataset
from ste_gan_tpu.train import encoder_data as jdata

SEQ_LEN = 25  # 200-sample windows, so the tiny utterances pack
MAX_SAMPLES = 8
SLOT_FIELDS = ("silent_su_targets", "silent_ph_targets", "silent_target_len",
               "silent_pred_start", "silent_pred_len")
FIELDS = ("emg_windows", "su_targets", "ph_targets", "frame_sample_id",
          "silent", "num_samples")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    generate_synthetic_corpus(root, num_train=10, num_valid=2, num_test=2,
                              num_sessions=2, min_frames=30, max_frames=60,
                              seed=3, silent_fraction=0.4)
    return root


@pytest.fixture(scope="module")
def mixed_ds(root):
    return EMGDataset(root, partition="train", only_include_voiced=False,
                      return_mfccs=False, return_emg_feats=False,
                      filter_by_length=False)


def _assert_equal(got, want, keys):
    for key in keys:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=key)


def _silent_dims(ds, order):
    silent = [i for i in range(len(ds))
              if ds.speaking_mode_ids[i] != C.SpeakingMode.NORMAL]
    assert any(i in silent for i in order), "fixture must include silent"
    return dict(max_silent=4,
                silent_target_frames=max(
                    len(ds[i][C.DataType.SPEECH_UNITS]) for i in silent),
                silent_pred_frames=max(ds.emg_lengths[i] // 16
                                       for i in silent))


def test_constants_are_a_copy():
    names = [n for n in dir(JEC) if n.isupper()]
    assert names
    assert {n: getattr(TEC, n) for n in names} == {
        n: getattr(JEC, n) for n in names}


def test_sampler_batches_identical_to_jax():
    lengths = list(np.random.default_rng(0).integers(2000, 6000, 60))
    t = tdata.SizeAwareSampler(lengths, max_len=16000, seed=4)
    j = jdata.SizeAwareSampler(lengths, max_len=16000, seed=4)
    for _ in range(3):  # the stream carries on across epochs
        got, want = list(t), list(j)
        assert got == want and len(got) > 5
        assert all(sum(lengths[i] for i in b) <= 16000 for b in got)


@pytest.mark.parametrize("mixed", [False, True])
def test_host_fold_identical_to_jax(mixed_ds, mixed):
    order = list(range(6)) if mixed else [
        i for i in range(len(mixed_ds))
        if mixed_ds.speaking_mode_ids[i] == C.SpeakingMode.NORMAL][:4]
    items = [mixed_ds[i] for i in order]
    n_win = tdata.windows_needed(
        [len(it[C.DataType.REAL_EMG]) for it in items], SEQ_LEN) + 1
    assert n_win == jdata.windows_needed(
        [len(it[C.DataType.REAL_EMG]) for it in items], SEQ_LEN) + 1
    kw = _silent_dims(mixed_ds, order) if mixed else {}
    got = tdata.fold_encoder_batch(items, seq_len=SEQ_LEN, n_win=n_win,
                                   max_samples=MAX_SAMPLES, **kw).as_dict()
    want = jdata.fold_encoder_batch(items, seq_len=SEQ_LEN, n_win=n_win,
                                    max_samples=MAX_SAMPLES, **kw).as_dict()
    assert set(got) == set(want) == set(FIELDS + (SLOT_FIELDS if mixed else ()))
    _assert_equal(got, want, list(want))


@pytest.mark.parametrize("mixed", [False, True])
def test_device_fold_identical_to_host_and_jax(root, mixed_ds, mixed):
    order = [7, 0, 3, 5, 1, 2] if mixed else [
        i for i in range(len(mixed_ds))
        if mixed_ds.speaking_mode_ids[i] == C.SpeakingMode.NORMAL][:4]
    items = [mixed_ds[i] for i in order]
    n_win = tdata.windows_needed(
        [len(it[C.DataType.REAL_EMG]) for it in items], SEQ_LEN) + 2
    kw = _silent_dims(mixed_ds, order) if mixed else {}
    host = tdata.fold_encoder_batch(items, seq_len=SEQ_LEN, n_win=n_win,
                                    max_samples=MAX_SAMPLES, **kw).as_dict()
    fold_kw = {k: v for k, v in kw.items() if k != "silent_pred_frames"}
    rows = np.zeros(MAX_SAMPLES, np.int32)
    rows[:len(order)] = order

    corpus = tdata.EncoderDeviceCorpus(mixed_ds, float_dtype=torch.float32,
                                       device="cpu")
    got = corpus.fold(torch.from_numpy(rows), torch.tensor(len(order),
                                                           dtype=torch.int32),
                      seq_len=SEQ_LEN, n_win=n_win, max_samples=MAX_SAMPLES,
                      **fold_kw)
    got = {k: v.numpy() for k, v in got.items()}
    _assert_equal(got, host, list(host))

    jds = JDataset(root, partition="train", only_include_voiced=False,
                   return_mfccs=False, return_emg_feats=False,
                   filter_by_length=False)
    jcorpus = jdata.EncoderDeviceCorpus(jds, float_dtype=jnp.float32)
    want = jax.jit(lambda rr, nn: jcorpus.fold(
        rr, nn, seq_len=SEQ_LEN, n_win=n_win, max_samples=MAX_SAMPLES,
        **fold_kw))(jnp.asarray(rows), jnp.asarray(len(order), jnp.int32))
    _assert_equal(got, {k: np.asarray(v) for k, v in want.items()}, list(want))


def test_device_fold_f16_is_a_cast_of_the_host_fold(mixed_ds):
    voiced = [i for i in range(len(mixed_ds))
              if mixed_ds.speaking_mode_ids[i] == C.SpeakingMode.NORMAL][:3]
    items = [mixed_ds[i] for i in voiced]
    n_win = tdata.windows_needed(
        [len(it[C.DataType.REAL_EMG]) for it in items], SEQ_LEN) + 1
    host = tdata.fold_encoder_batch(items, seq_len=SEQ_LEN, n_win=n_win,
                                    max_samples=4)
    corpus = tdata.EncoderDeviceCorpus(mixed_ds, device="cpu")
    assert corpus.emg_flat.dtype == torch.float16
    rows = torch.zeros(4, dtype=torch.int32)
    rows[:3] = torch.tensor(voiced)
    got = corpus.fold(rows, torch.tensor(3), seq_len=SEQ_LEN, n_win=n_win,
                      max_samples=4)
    np.testing.assert_array_equal(got["emg_windows"].numpy(),
                                  host.emg_windows.astype(np.float16))
    np.testing.assert_array_equal(got["su_targets"].numpy(),
                                  host.su_targets.astype(np.float16))
    assert corpus.nbytes > 0


def test_fold_overflow_errors(mixed_ds):
    items = [mixed_ds[i] for i in range(6)]
    total = sum(len(it[C.DataType.REAL_EMG]) for it in items)
    kw = _silent_dims(mixed_ds, range(6))
    n_silent = sum(mixed_ds.speaking_mode_ids[i] != C.SpeakingMode.NORMAL
                   for i in range(6))
    n_win = -(-total // (SEQ_LEN * 8))
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="exceeds capacity"):
            mod.fold_encoder_batch(items, seq_len=SEQ_LEN, n_win=n_win - 1,
                                   max_samples=MAX_SAMPLES)
        with pytest.raises(ValueError, match="max_samples"):
            mod.fold_encoder_batch(items, seq_len=SEQ_LEN, n_win=n_win,
                                   max_samples=5)
        with pytest.raises(ValueError, match="max_silent"):
            mod.fold_encoder_batch(items, seq_len=SEQ_LEN, n_win=n_win,
                                   max_samples=MAX_SAMPLES,
                                   **dict(kw, max_silent=n_silent - 1))
        with pytest.raises(ValueError, match="target frames"):
            mod.fold_encoder_batch(
                items, seq_len=SEQ_LEN, n_win=n_win, max_samples=MAX_SAMPLES,
                **dict(kw, silent_target_frames=kw["silent_target_frames"] - 1))
        with pytest.raises(ValueError, match="prediction frames"):
            mod.fold_encoder_batch(
                items, seq_len=SEQ_LEN, n_win=n_win, max_samples=MAX_SAMPLES,
                **dict(kw, silent_pred_frames=kw["silent_pred_frames"] - 1))


def test_voiced_length_mismatch_raises():
    item = {C.DataType.REAL_EMG: np.zeros((160, 8), np.float32),
            C.DataType.SPEECH_UNITS: np.zeros((9, 256), np.float32),
            C.DataType.PHONEMES: np.zeros(9, np.int32),
            C.DataType.SPEAKING_MODE_ID: C.SpeakingMode.NORMAL}
    with pytest.raises(ValueError, match="target frames"):
        tdata.fold_encoder_batch([item], seq_len=SEQ_LEN, n_win=1,
                                 max_samples=2)
