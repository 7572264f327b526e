"""The port's corpus preparation CLIs (``python -m ste_gan_torch.clean_audio``
and ``python -m ste_gan_torch.prep_data``) against the JAX package's scripts
(``scripts/clean_audio.py``, ``scripts/prep_data_gaddy_and_klein.py``) on
tests/test_etl_scripts.py's synthetic raw Gaddy & Klein tree, on the CPU,
with that test's deterministic HuBERT stub on both sides.

Tolerances: the spectral gate within 1e-6 of the JAX gate; the prepared
corpus has the same files and splits, equal phonemes and transcriptions,
units rtol 1e-5 (f32 projections of equal audio), MFCCs rtol 2e-4 / atol
5e-3 (tests/test_mfcc_golden.py's), EMG and EMG features rtol 1e-5 /
atol 1e-6 (f32 out of f64 chains).
"""
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ste_gan_torch import clean_audio as tclean
from ste_gan_torch import constants as C
from ste_gan_torch import prep_data as tprep
from ste_gan_torch.data.dataset import EMGDataset
from ste_gan_torch.etl.audio_dsp import read_audio_file

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import clean_audio as jclean  # noqa: E402
import prep_data_gaddy_and_klein as jprep  # noqa: E402
from test_etl_scripts import HubertStub, _write_session  # noqa: E402

SR = 16_000


def _raw_tree(root: Path) -> Path:
    """tests/test_etl_scripts.py's tree: a voiced-parallel session (3
    utterances), a silent-parallel one whose book locations match voiced
    ones (dev and test), a nonparallel one; silence clip 0 in each."""
    import json

    src, align = root / "emg_data", root / "text_alignments"
    rng = np.random.default_rng(42)
    _write_session(src / "voiced_parallel_data" / "v_sess", align, rng, [
        (0, "", "book1", -1, 1.0), (1, "hello world", "book1", 10, 2.0),
        (2, "second utterance", "book1", 11, 2.56),
        (3, "third utterance", "book1", 12, 2.0)])
    _write_session(src / "silent_parallel_data" / "s_sess", align, rng, [
        (0, "", "book1", -1, 1.0), (1, "hello world", "book1", 10, 2.56),
        (2, "second utterance", "book1", 11, 2.0)])
    _write_session(src / "nonparallel_data" / "n_sess", align, rng, [
        (0, "", "book2", -1, 1.0), (1, "nonparallel utterance", "book2", 50,
                                    2.0)])
    (root / "testset_largedev.json").write_text(json.dumps({
        "dev": [["book1", 10]], "test": [["book1", 11]]}))
    return root


@pytest.mark.parametrize("n", [16_000, 16_001, 32_123])
def test_spectral_gate_matches_jax(n):
    rng = np.random.default_rng(n)
    noise = 0.02 * rng.normal(size=SR)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / SR)
             + 0.02 * rng.normal(size=n))
    got = tclean.spectral_gate_denoise(torch.from_numpy(audio),
                                       torch.from_numpy(noise)).numpy()
    want = jclean.spectral_gate_denoise(audio, noise)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_clean_audio_cli_matches_jax(tmp_path, monkeypatch, caplog):
    """Both cleaners on copies of one raw tree: the same files, within
    1e-6; the port logs its backend; a second run cleans nothing."""
    port = _raw_tree(tmp_path / "port")
    ref = tmp_path / "jax"
    shutil.copytree(port, ref)
    with caplog.at_level("INFO"):
        assert tclean.main(["--source_data_dir", str(port / "emg_data"),
                            "--device", "cpu"]) == 9
    assert "spectral gate on cpu" in caplog.text
    monkeypatch.setattr(sys, "argv", [
        "clean_audio.py", "--source_data_dir", str(ref / "emg_data")])
    jclean.main()
    got_files = sorted(p.relative_to(port) for p in port.rglob("*_clean.*"))
    want_files = sorted(p.relative_to(ref) for p in ref.rglob("*_clean.*"))
    assert got_files == want_files and len(got_files) == 9
    for rel in got_files:
        got, sr = read_audio_file(port / rel)
        want, _ = read_audio_file(ref / rel)
        assert sr == SR and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=str(rel))
    cleaner = tclean.AudioCleaner("cpu")
    session = port / "emg_data" / "voiced_parallel_data" / "v_sess"
    assert tclean.clean_directory(session, cleaner) == 0


def test_clean_audio_other_backends_with_stub_packages(tmp_path, monkeypatch):
    """The noisereduce + MetricGAN+ branch, with stub modules (neither
    package is installed): the 1.x call after the 2.x one is refused, and
    the enhancer is loaded once per cleaner."""
    calls = {"reduce": 0, "enhance": 0, "from_hparams": 0}
    fake_nr = types.ModuleType("noisereduce")

    def reduce_noise(**kwargs):
        if "y" in kwargs:
            raise TypeError("reduce_noise() got an unexpected keyword 'y'")
        calls["reduce"] += 1
        return kwargs["audio_clip"] * 0.5

    fake_nr.reduce_noise = reduce_noise

    class FakeEnhancer:
        @classmethod
        def from_hparams(cls, source, savedir):
            assert source == "speechbrain/metricgan-plus-voicebank"
            calls["from_hparams"] += 1
            return cls()

        def enhance_batch(self, noisy, lengths):
            assert noisy.shape[0] == 1 and noisy.dtype == torch.float32
            assert float(lengths[0]) == 1.0
            calls["enhance"] += 1
            return noisy * 2.0

    fake_sb = types.ModuleType("speechbrain")
    fake_pre = types.ModuleType("speechbrain.pretrained")
    fake_pre.SpectralMaskEnhancement = FakeEnhancer
    fake_sb.pretrained = fake_pre
    monkeypatch.setitem(sys.modules, "noisereduce", fake_nr)
    monkeypatch.setitem(sys.modules, "speechbrain", fake_sb)
    monkeypatch.setitem(sys.modules, "speechbrain.pretrained", fake_pre)

    sess = tmp_path / "emg_data" / "voiced_parallel_data" / "e_sess"
    _write_session(sess, tmp_path / "align", np.random.default_rng(7), [
        (0, "", "book1", -1, 1.0), (1, "enhanced", "book1", 99, 2.0)])
    cleaner = tclean.AudioCleaner("cpu")
    assert tclean.clean_directory(sess, cleaner) == 2
    assert calls == {"reduce": 2, "enhance": 2, "from_hparams": 1}
    raw, _ = read_audio_file(sess / "1_audio.wav")
    out, _ = read_audio_file(sess / "1_audio_clean.wav")
    assert len(out) == len(raw) and np.all(np.isfinite(out))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The raw tree cleaned once, then prepared by both packages."""
    root = _raw_tree(tmp_path_factory.mktemp("raw"))
    tclean.main(["--source_data_dir", str(root / "emg_data"), "--device",
                 "cpu"])
    common = ["--source_data_dir", str(root / "emg_data"),
              "--text_alignment_dir", str(root / "text_alignments"),
              "--testset_file", str(root / "testset_largedev.json")]
    monkeypatch = pytest.MonkeyPatch()
    try:
        monkeypatch.setattr(jprep, "load_hubert", lambda *a, **k: HubertStub())
        monkeypatch.setattr(tprep, "load_hubert", lambda *a, **k: HubertStub())
        monkeypatch.setattr(sys, "argv", ["prep_data_gaddy_and_klein.py",
                                          *common, "--target_dir",
                                          str(root / "jax")])
        jprep.main()
        count = tprep.main([*common, "--target_dir", str(root / "port"),
                            "--device", "cpu"])
    finally:
        monkeypatch.undo()
    return root, count


def test_prep_writes_the_same_files_and_splits(prepared):
    root, count = prepared
    got = sorted(p.relative_to(root / "port") for p in (root / "port").rglob("*"))
    want = sorted(p.relative_to(root / "jax") for p in (root / "jax").rglob("*"))
    assert got == want and count == 6
    ids = {split: sorted(p.stem for p in (root / "port" / split / "emg").glob(
        "*.npy")) for split in ("train", "valid", "test")}
    assert ids["valid"] == ["silent_parallel_data_s_sess__1__silent",
                            "voiced_parallel_data_v_sess__1__normal"]
    assert ids["test"] == ["silent_parallel_data_s_sess__2__silent",
                           "voiced_parallel_data_v_sess__2__normal"]
    assert len(ids["train"]) == 2


TOLS = {"units": dict(rtol=1e-5, atol=1e-6),
        "mfccs": dict(rtol=2e-4, atol=5e-3),
        "emg": dict(rtol=1e-5, atol=1e-6),
        "emg_feats": dict(rtol=1e-5, atol=1e-6)}


@pytest.mark.parametrize("kind", ["phonemes", "units", "mfccs", "emg",
                                  "emg_feats", "transcriptions", "audio"])
def test_prep_artifacts_match_jax(prepared, kind):
    root, _ = prepared
    files = sorted((root / "jax").rglob(f"*/{kind}/*"))
    assert files
    for want_path in files:
        got_path = root / "port" / want_path.relative_to(root / "jax")
        if kind == "transcriptions":
            assert got_path.read_text() == want_path.read_text()
            continue
        if kind == "audio":
            got, _ = read_audio_file(got_path)
            want, _ = read_audio_file(want_path)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
            continue
        got, want = np.load(got_path), np.load(want_path)
        assert got.dtype == want.dtype and got.shape == want.shape, want_path
        if kind == "phonemes":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOLS[kind],
                                       err_msg=str(want_path))


def test_prep_invariants_and_dataset_load(prepared):
    root, _ = prepared
    target = root / "port"
    for split_dir in (target / s for s in ("train", "valid", "test")):
        for emg_path in (split_dir / "emg").glob("*.npy"):
            utt = emg_path.stem
            emg = np.load(emg_path)
            units = np.load(split_dir / "units" / f"{utt}.npy")
            feats = np.load(split_dir / "emg_feats" / f"{utt}.npy")
            mfccs = np.load(split_dir / "mfccs" / f"{utt}.npy")
            assert emg.dtype == np.float32 and np.all(np.abs(emg) <= 1.0)
            assert len(mfccs) == 2 * len(units)
            if utt.endswith(C.SpeakingMode.NORMAL):
                assert len(emg) == 16 * len(units)
                assert len(feats) == 2 * len(units)
    train = EMGDataset(target, partition="train", strict=True,
                       filter_by_length=False, only_include_voiced=False)
    assert len(train) == 2
    assert train[0][C.DataType.REAL_EMG].shape[1] == 8
    # Silent utterances carry their voiced reference's units.
    valid = target / "valid" / "units"
    np.testing.assert_array_equal(
        np.load(valid / "silent_parallel_data_s_sess__1__silent.npy"),
        np.load(valid / "voiced_parallel_data_v_sess__1__normal.npy"))


def test_prep_refuses_missing_cleaned_audio(tmp_path):
    root = _raw_tree(tmp_path)
    prep = tprep.GaddyKleinPrep(
        [root / "emg_data" / "silent_parallel_data"],
        [root / "emg_data" / "voiced_parallel_data"],
        root / "text_alignments", root / "testset_largedev.json",
        hubert=HubertStub(), device="cpu", no_testset=True)
    with pytest.raises(FileNotFoundError, match="clean_audio"):
        prep[0]
