"""The port's ETL signal processing (``ste_gan_torch/etl``,
``ste_gan_torch/ops/iir.py``) against scipy and the JAX package, on the CPU,
inputs from numpy seeds.

Tolerances: filter designs, ``lfilter_zi``, ``hilbert`` and ``resample``
rtol 1e-12 against ``scipy.signal`` (the same f64 steps), ``resample_poly``
1e-10 (a polyphase sum in another order); the plain ``filtfilt_cascade``
within 1e-10 of ``max|x|`` of chained ``scipy.signal.filtfilt`` (the
kernel's arithmetic in scipy's order); the f64 EMG stages within 1e-9
relative of ``ste_gan_tpu.etl.emg_dsp``, ``get_emg_features`` rtol 1e-5 /
atol 1e-6 (f32 out); the MFCC rtol 2e-4 / atol 5e-3 against
``mfcc_jax`` and the golden vectors (tests/test_mfcc_golden.py's
tolerance: an f32 pipeline on dB values up to ~600); audio I/O bit for bit.
"""
import numpy as np
import pytest
import scipy.io.wavfile
import scipy.signal as ss
import torch

from ste_gan_torch.etl import audio_dsp as TA
from ste_gan_torch.etl import emg_dsp as TE
from ste_gan_torch.etl import filters
from ste_gan_torch.ops.iir import filtfilt_cascade, prepare_stages
from ste_gan_tpu.etl import audio_dsp as JA
from ste_gan_tpu.etl import emg_dsp as JE

FIXTURE = "tests/fixtures/mfcc_golden.npz"


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, (
        what, np.abs(got - want).max() / scale)


# ---------------------------------------------------------------------------
# Filter design and spectral helpers against scipy
# ---------------------------------------------------------------------------


DESIGNS = {
    **{f"notch_{60 * h}": (lambda h=h: filters.iirnotch(60 * h, 30, 1000),
                           lambda h=h: ss.iirnotch(60 * h, 30, 1000))
       for h in range(1, 8)},
    "drift_highpass": (lambda: filters.butter(3, 2, "highpass", fs=1000),
                       lambda: ss.butter(3, 2, "highpass", fs=1000)),
    "bandpass": (lambda: filters.butter(2, (2, 400), "bandpass", fs=1000),
                 lambda: ss.butter(2, (2, 400), "bandpass", fs=1000)),
    "lowpass_10": (lambda: filters.butter(2, 10, "lowpass", fs=1000),
                   lambda: ss.butter(2, 10, "lowpass", fs=1000)),
    "hilbert_lowpass": (lambda: filters.butter(4, 20, fs=800, btype="low"),
                        lambda: ss.butter(4, 20, fs=800, btype="low")),
    "relative_corner": (lambda: filters.butter(5, 0.3),
                        lambda: ss.butter(5, 0.3)),
}


@pytest.mark.parametrize("name", list(DESIGNS))
def test_design_and_zi_match_scipy(name):
    port, ref = DESIGNS[name]
    (b, a), (wb, wa) = port(), ref()
    np.testing.assert_allclose(b, wb, rtol=1e-12, atol=0)
    np.testing.assert_allclose(a, wa, rtol=1e-12, atol=0)
    np.testing.assert_allclose(filters.lfilter_zi(b, a), ss.lfilter_zi(wb, wa),
                               rtol=1e-12, atol=1e-15)


def test_design_refuses_bad_corners():
    with pytest.raises(ValueError):
        filters.butter(2, 600, fs=1000)
    with pytest.raises(ValueError):
        filters.butter(2, (400, 2), "bandpass", fs=1000)
    with pytest.raises(ValueError):
        filters.butter(2, 10, "bandstop", fs=1000)


@pytest.mark.parametrize("n", [1000, 1001, 1600, 1599])
def test_hilbert_and_resample_match_scipy(n):
    x = np.random.default_rng(n).normal(size=(3, n))
    _assert_rel(filters.hilbert(_t(x)).numpy(), ss.hilbert(x), 1e-12, "hilbert")
    for num in (n // 8, n // 8 + 1, 200, 2 * n, 2 * n + 1):
        _assert_rel(filters.resample(_t(x), num).numpy(),
                    ss.resample(x, num, axis=-1), 1e-12, f"resample {num}")


@pytest.mark.parametrize("up,down", [(16000, 44100), (16000, 22050),
                                     (16000, 8000), (160, 147), (1, 3), (3, 7)])
def test_resample_poly_matches_scipy(up, down):
    x = np.random.default_rng(up + down).normal(size=(2, 3001))
    _assert_rel(filters.resample_poly(_t(x), up, down).numpy(),
                ss.resample_poly(x, up, down, axis=-1), 1e-10)


# ---------------------------------------------------------------------------
# The filter cascade (plain version) against chained scipy filtfilt
# ---------------------------------------------------------------------------


def _emg_chain():
    return ([ss.iirnotch(60 * h, 30, 1000) for h in range(1, 8)]
            + [ss.butter(3, 2, "highpass", fs=1000)])


@pytest.mark.parametrize("chain", ["notch_and_drift", "hilbert_lowpass",
                                   "bandpass", "first_order"])
def test_filtfilt_cascade_matches_chained_scipy(chain):
    designs = {"notch_and_drift": _emg_chain(),
               "hilbert_lowpass": [ss.butter(4, 20, fs=800, btype="low")],
               "bandpass": [ss.butter(2, (2, 400), "bandpass", fs=1000)],
               "first_order": [ss.butter(1, 10, fs=1000)]}[chain]
    rng = np.random.default_rng(7)
    length = 2500
    lengths = [length, 1700, length - 1, 31]
    # A DC offset and a slow swing, which the high-pass amplifies
    # rounding in, beside the noise.
    x = (rng.normal(0, 20, (4, length)) + 300
         + 200 * np.sin(np.arange(length) / 60.0))
    got = filtfilt_cascade(_t(x), lengths, designs).numpy()
    for r, n in enumerate(lengths):
        want = x[r, :n]
        for b, a in designs:
            want = ss.filtfilt(b, a, want)
        assert np.abs(got[r, :n] - want).max() <= 1e-10 * np.abs(x[r, :n]).max()
        np.testing.assert_array_equal(got[r, n:], x[r, n:])


def test_filtfilt_cascade_takes_a_length_tensor_and_checks_inputs():
    x = np.random.default_rng(0).normal(size=(2, 100))
    design = [ss.butter(2, 10, fs=1000)]
    a = filtfilt_cascade(_t(x), torch.tensor([100, 60]), design)
    b = filtfilt_cascade(_t(x), [100, 60], design)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="exceed the padding"):
        filtfilt_cascade(_t(x), [100, 9], design)  # scipy: padlen 9
    with pytest.raises(TypeError):
        filtfilt_cascade(_t(x).float(), [100, 60], design)
    with pytest.raises(ValueError):
        filtfilt_cascade(_t(x), [100], design)
    coefs, taps, pads = prepare_stages(_emg_chain())
    assert list(taps) == [3] * 7 + [4] and list(pads) == [9] * 7 + [12]
    assert coefs.shape == (8, 3, 8)


# ---------------------------------------------------------------------------
# The EMG chain against the JAX package
# ---------------------------------------------------------------------------


def test_subsample_end_points_match_jax():
    """``np.arange(0, times[-1], 1 / 800)`` has a float end point; every
    length from 2 to 2,600 gives the same count and values."""
    rng = np.random.default_rng(1)
    for n in range(2, 2601):
        x = rng.normal(size=n)
        got = TE.subsample(_t(x), 800, 1000).numpy()
        want = JE.subsample(x, 800, 1000)
        assert got.shape == want.shape, n
        if want.size:
            _assert_rel(got, want, 1e-12, str(n))


@pytest.fixture(scope="module")
def emg():
    rng = np.random.default_rng(3)
    raw, before, after = (rng.normal(0, 20, (n, 8)) + 40 for n in
                          (2300, 1500, 1700))
    return raw, before, after, JE.pre_process_emg_signal(raw, before, after)


def test_pre_process_matches_jax(emg):
    raw, before, after, want = emg
    got = TE.pre_process_emg_signal(_t(raw), _t(before), _t(after)).numpy()
    _assert_rel(got, want, 1e-9)


def test_pre_process_without_context_matches_jax():
    raw = np.random.default_rng(4).normal(0, 20, (1200, 8))
    empty = np.zeros((0, 8))
    got = TE.pre_process_emg_signal(_t(raw), _t(empty), _t(empty)).numpy()
    _assert_rel(got, JE.pre_process_emg_signal(raw, empty, empty), 1e-9)


ONE_CHANNEL = [("subsample", (800, 1000)), ("notch", (60, 1000)),
               ("notch_harmonics", (60, 1000)), ("remove_drift", (1000,)),
               ("bandpass_signal", (1000,)),
               ("lowpass_after_bandpass", (1000,)),
               ("average_by_points", (8,)), ("average_by_points", (9,)),
               ("double_average", ()), ("calculate_hilbert_envelope", ()),
               ("calculate_hilbert_transform_feats", ())]


@pytest.mark.parametrize("name,args", ONE_CHANNEL)
def test_emg_function_matches_jax(emg, name, args):
    x = emg[3][:, 2]
    got = getattr(TE, name)(_t(x), *args).numpy()
    _assert_rel(got, getattr(JE, name)(x, *args), 1e-9, name)


def test_channels_at_once_equal_one_by_one(emg):
    """The port filters every channel in one cascade; each column equals
    the JAX package's per-channel result."""
    x = emg[3]
    got = TE.remove_drift(_t(x), 1000).numpy()
    want = JE.apply_to_all(JE.remove_drift, x, 1000)
    _assert_rel(got, want, 1e-9)
    got = TE.calculate_hilbert_transform_feats(_t(x), max_num_frames=150).numpy()
    want = np.stack([JE.calculate_hilbert_transform_feats(
        x[:, i], max_num_frames=150) for i in range(8)], 1)
    _assert_rel(got, want, 1e-9)


@pytest.mark.parametrize("name", ["_frame_rms", "_frame_zcr"])
def test_frame_features_match_jax(emg, name):
    x = emg[3][:, 1].copy()
    x[::7] = 0.0
    x[::11] = -0.0
    x[5::13] = 5e-11  # snapped to +0
    got = getattr(TE, name)(_t(x), 26, 8).numpy()
    _assert_rel(got, getattr(JE, name)(x, 26, 8), 1e-12, name)


@pytest.mark.parametrize("pad,subtract_mean,add_hilbert", [
    (True, True, True), (False, True, True), (False, False, False)])
def test_get_emg_features_match_jax(emg, pad, subtract_mean, add_hilbert):
    x = emg[3]
    got = TE.get_emg_features(_t(x), pad=pad, subtract_mean=subtract_mean,
                              add_hilbert=add_hilbert)
    want = JE.get_emg_features(x, pad=pad, subtract_mean=subtract_mean,
                               add_hilbert=add_hilbert)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cut_emg_to_hubert_units(emg):
    x = emg[3]
    np.testing.assert_array_equal(TE.cut_emg_to_hubert_units(_t(x), 50).numpy(),
                                  JE.cut_emg_to_hubert_units(x, 50))
    with pytest.raises(ValueError):
        TE.cut_emg_to_hubert_units(_t(x), 10_000)


# ---------------------------------------------------------------------------
# Audio: MFCC, normalisation, I/O, TextGrids
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.mark.parametrize("name", ["dc", "impulse", "sine_mel40", "noise"])
def test_mfcc_matches_golden_and_jax(golden, name):
    calc = TA.MFCCsCalculator(device="cpu")
    got = calc(golden[f"in_{name}"])
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, golden[f"out_{name}"], rtol=2e-4, atol=5e-3)
    np.testing.assert_allclose(got, JA.MFCCsCalculator()(golden[f"in_{name}"]),
                               rtol=2e-4, atol=5e-3)


def test_mfcc_tables_and_precision_guard():
    np.testing.assert_array_equal(TA.mel_filterbank(257, 80, 16_000),
                                  JA.mel_filterbank(257, 80, 16_000))
    np.testing.assert_array_equal(TA._dct_ortho(25, 80), JA._dct_ortho(25, 80))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with TA.full_f32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("scale", [0.3, 30.0])
def test_normalize_volume_matches_jax(scale):
    a = np.random.default_rng(5).normal(size=40_000) * scale
    _assert_rel(TA.normalize_volume(_t(a)).numpy(), JA.normalize_volume(a),
                1e-12)


def test_wav_round_trips_bit_for_bit_both_ways(tmp_path):
    x = (np.random.default_rng(6).normal(size=1001) * 0.3).astype(np.float32)
    pj = JA.write_audio_file(tmp_path / "jax.flac", x, 16_000)
    pt = TA.write_audio_file(tmp_path / "port.flac", x, 16_000)
    assert pj.suffix == pt.suffix == ".wav"
    assert pj.read_bytes() == pt.read_bytes()
    port_reads_jax, sr = TA.read_audio_file(pj)
    jax_reads_port, sr2 = JA.read_audio_file(pt)
    assert sr == sr2 == 16_000 and port_reads_jax.dtype == np.float64
    np.testing.assert_array_equal(port_reads_jax, x.astype(np.float64))
    np.testing.assert_array_equal(jax_reads_port, x.astype(np.float64))
    assert TA.find_audio_file(tmp_path / "port.flac") == pt


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float64])
def test_pcm_and_float_wavs_read_as_jax_reads_them(tmp_path, dtype):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(500, 2)) * 1000).astype(dtype)
    scipy.io.wavfile.write(tmp_path / "m.wav", 8000, x)
    got, sr = TA.read_audio_file(tmp_path / "m.wav")
    want, wsr = JA.read_audio_file(tmp_path / "m.wav")
    assert sr == wsr == 8000
    np.testing.assert_array_equal(got, want)


def test_load_audio_resamples_as_jax(tmp_path):
    x = (np.random.default_rng(9).normal(size=22050) * 0.1).astype(np.float32)
    scipy.io.wavfile.write(tmp_path / "a.wav", 22050, x)
    got = TA.load_audio(tmp_path / "a.wav", device="cpu").numpy()
    _assert_rel(got, JA.load_audio(tmp_path / "a.wav"), 1e-10)
    cut = TA.cut_audio_to_soft_speech_match_unit_frame_rate(_t(got)).numpy()
    np.testing.assert_array_equal(
        cut, JA.cut_audio_to_soft_speech_match_unit_frame_rate(got))


def _textgrid(tmp_path, duration, phones):
    n = len(phones)
    edges = np.linspace(0.0, duration, n + 1)
    intervals = "\n".join(
        f"        intervals [{i + 1}]:\n            xmin = {edges[i]:.4f}\n"
        f"            xmax = {edges[i + 1]:.4f}\n            text = \"{ph}\""
        for i, ph in enumerate(phones))
    path = tmp_path / "utt.TextGrid"
    path.write_text(
        'File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
        f'xmax = {duration:.4f}\ntiers? <exists>\nsize = 2\nitem []:\n'
        '    item [1]:\n        class = "IntervalTier"\n        name = "words"\n'
        f'        xmin = 0\n        xmax = {duration:.4f}\n'
        '        intervals: size = 1\n        intervals [1]:\n'
        f'            xmin = 0\n            xmax = {duration:.4f}\n'
        '            text = "hello"\n'
        '    item [2]:\n        class = "IntervalTier"\n        name = "phones"\n'
        f'        xmin = 0\n        xmax = {duration:.4f}\n'
        f'        intervals: size = {n}\n{intervals}\n')
    return path


def test_textgrid_phonemes_equal_jax(tmp_path):
    path = _textgrid(tmp_path, 2.37, ["", "HH", "AH0", "L", "OW1", "sp", "spn"])
    assert TA.parse_textgrid_tier(path) == JA.parse_textgrid_tier(path)
    got, want = TA.read_phonemes(path), JA.read_phonemes(path)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TA.read_phonemes(path, 100),
                                  JA.read_phonemes(path, 100))
    with pytest.raises(ValueError):
        TA.parse_textgrid_tier(path, "syllables")


def test_align_speech_units_and_mfccs_matches_jax():
    rng = np.random.default_rng(10)
    for n_units, n_mfcc in ((50, 101), (50, 99), (40, 100)):
        units = rng.normal(size=(n_units, 4))
        mfccs = rng.normal(size=(n_mfcc, 3))
        got = TA.align_speech_units_and_mfccs(_t(units), _t(mfccs))
        want = JA.align_speech_units_and_mfccs(units, mfccs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# The kernel's launch: its row-major buffer and its variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,p0,resident,chunks", [
    (15_000, 12, True, 1),    # an utterance and its neighbours, the cascade
    (4_000, 15, True, 1),     # the Hilbert envelope's low-pass at 800 Hz
    (4_000, 12, True, 1),     # the widest of the 512 mixed rows
    (29_030, 12, True, 1),    # the widest row that stays resident
    (29_031, 12, False, 15),  # one sample more: streamed
    (40_000, 12, False, 20)])  # three long utterances
def test_filtfilt_plan(length, p0, resident, chunks):
    """Resident while the padded row (rounded up to even) and its barrier
    fit in a block's 232,448 bytes of shared memory, else streamed through
    the ring; never more shared memory than a block may hold."""
    from ste_gan_torch.ops import iir

    plan = iir.plan_filtfilt(length, p0)
    assert plan.resident is resident and plan.chunks == chunks
    assert plan.width % 2 == 0 and plan.width - 1 <= length + 2 * p0 <= plan.width
    assert plan.smem_bytes <= iir.SMEM_LIMIT == 232_448
    if resident:
        assert plan.smem_bytes == 16 + 8 * plan.width
    else:
        assert 16 + 8 * plan.width > iir.SMEM_LIMIT
        assert (chunks - 1) * iir.CHUNK < plan.width <= chunks * iir.CHUNK


@pytest.mark.parametrize("width_extra", [0, 1])
def test_kernel_buffer_holds_each_row_at_p0(width_extra):
    from ste_gan_torch.ops import iir

    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 21)))
    p0 = 9
    plan = iir.plan_filtfilt(21 + width_extra, p0)
    buf = iir.kernel_buffer(x, p0, plan.width)
    assert buf.shape == (3, plan.width) and buf.dtype == torch.float64
    assert buf.is_contiguous() and plan.width % 2 == 0
    assert torch.equal(buf[:, p0:p0 + 21], x)
    assert not buf[:, :p0].any() and not buf[:, p0 + 21:].any()
