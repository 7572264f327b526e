"""Offline corpus preparation for the Gaddy & Klein "Digital Voicing of
Silent Speech" EMG dataset, on the card.

    python -m ste_gan_torch.prep_data --source_data_dir raw_data/emg_data \\
        --text_alignment_dir raw_data/text_alignments \\
        --testset_file raw_data/testset_largedev.json \\
        --target_dir data/gaddy_complete [--dry_run] [--device cpu]

Counterpart of ``scripts/prep_data_gaddy_and_klein.py`` (the reference's
prep), with its flags, split routing, file names and artifacts: raw 1 kHz
EMG (``.npy``) filtered with the neighbouring utterances as context (60 Hz
notch harmonics and drift removal, one ``filtfilt_kernel`` launch per
utterance) and resampled to 800 Hz; Soft Speech Units (50 Hz) from the
Soft HuBERT hub model; MFCCs (100 Hz); 100 Hz EMG TD features (a second
launch for the Hilbert envelope's low-pass); phoneme sequences from
forced-alignment TextGrids; lengths aligned to ``len(emg) == 16 *
len(units)``; the EMG scaled by 1/100 and tanh-bounded; per-utterance
``.npy`` artifacts in the ``{split}/{emg,units,phonemes,mfccs,emg_feats,
transcriptions,audio}`` layout that ``ste_gan_torch/data/dataset.py``
reads. Voiced references of dev/test silent utterances route to
valid/test.

The HuBERT contract: ``hubert.units(audio [1, 1, T] f32 on the device)
-> [1, T // 320, 256]``. ``load_hubert`` downloads the model through
``torch.hub``; only :func:`main` calls it. The signal work runs on ``cuda``
unless ``--device cpu`` is given; without a card it raises.

Known reference bug not replicated: the reference's length fix
``emg = emg[len(units) * ratio]`` indexes one row instead of slicing
(reference scripts/prep_data_gaddy_and_klein.py:396); this prep slices.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from ste_gan_torch.constants import PHONEME_INVENTORY, SpeakingMode
from ste_gan_torch.device import resolve_device
from ste_gan_torch.etl.audio_dsp import (
    MFCCsCalculator, align_speech_units_and_mfccs,
    cut_audio_to_soft_speech_match_unit_frame_rate, find_audio_file,
    load_audio, read_phonemes, write_audio_file)
from ste_gan_torch.etl.emg_dsp import (
    get_emg_features, pre_process_emg_signal, to_device)


def load_hubert(device: str = "cuda"):
    """Soft HuBERT via torch.hub (network required on first run)."""
    return torch.hub.load("bshall/hubert:main", "hubert_soft").to(device)


class EMGSessionDirectory:
    def __init__(self, session_index: int, directory: Path, silent: bool,
                 exclude_from_testset: bool = False):
        self.session_index = session_index
        self.directory = Path(directory)
        self.silent = silent
        self.exclude_from_testset = exclude_from_testset


def load_raw_emg_with_context(base_dir: Path, index: int):
    """The raw EMG of utterance ``index`` and of its neighbours (empty where
    a neighbour is missing), numpy f64 ``[T, C]``."""
    raw = np.load(base_dir / f"{index}_emg.npy")

    def _maybe(path):
        return np.load(path) if path.exists() else np.zeros((0, raw.shape[1]))

    return raw, _maybe(base_dir / f"{index - 1}_emg.npy"), \
        _maybe(base_dir / f"{index + 1}_emg.npy")


def only_alphanumeric(text: str) -> str:
    return re.sub(r"\W+", "", text.strip())


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class GaddyKleinPrep:
    """Discovers utterances across session directories and extracts aligned
    artifacts for one split selection (train / dev / test), on ``device``.
    A sample is computed when it is indexed and not kept (each loop below
    reads each sample once), so the card holds one utterance at a time."""

    def __init__(self, silent_dirs: List[Path], voiced_dirs: List[Path],
                 text_align_directory: Path, testset_file: Path,
                 hubert=None, device=None, dev: bool = False,
                 test: bool = False, no_testset: bool = False):
        self.text_align_directory = Path(text_align_directory)
        self.hubert = hubert
        self.device = resolve_device(device)
        self.mfcc_calc = MFCCsCalculator(device=self.device)

        if no_testset:
            devset, testset = [], []
        else:
            testset_json = json.loads(Path(testset_file).read_text())
            devset, testset = testset_json["dev"], testset_json["test"]

        directories: List[EMGSessionDirectory] = []
        for sd in silent_dirs:
            for session_dir in sorted(Path(sd).iterdir()):
                if "DS_Store" in session_dir.name:
                    continue
                directories.append(EMGSessionDirectory(
                    len(directories), session_dir, silent=True))
        has_silent = len(silent_dirs) > 0
        for vd in voiced_dirs:
            for session_dir in sorted(Path(vd).iterdir()):
                if "DS_Store" in session_dir.name:
                    continue
                directories.append(EMGSessionDirectory(
                    len(directories), session_dir, silent=False,
                    exclude_from_testset=has_silent))

        self.example_indices: List[Tuple[EMGSessionDirectory, int]] = []
        self.voiced_data_locations: Dict[Tuple, Tuple] = {}
        for dir_info in directories:
            for fname in sorted(p.name for p in dir_info.directory.iterdir()):
                match = re.match(r"(\d+)_info.json", fname)
                if match is None:
                    continue
                info = json.loads((dir_info.directory / fname).read_text())
                if not only_alphanumeric(info["text"]) or info["sentence_index"] < 0:
                    continue
                loc = [info["book"], info["sentence_index"]]
                in_test = loc in testset
                in_dev = loc in devset
                idx = int(match.group(1))
                if ((test and in_test and not dir_info.exclude_from_testset)
                        or (dev and in_dev and not dir_info.exclude_from_testset)
                        or (not test and not dev and not in_test and not in_dev)):
                    self.example_indices.append((dir_info, idx))
                if not dir_info.silent:
                    self.voiced_data_locations[tuple(loc)] = (dir_info, idx)
        self.example_indices.sort(key=lambda pair: pair[0].session_index)
        self.num_sessions = len(directories)

    def __len__(self) -> int:
        return len(self.example_indices)

    # ------------------------------------------------------------------
    def load_utterance(self, dir_info: EMGSessionDirectory, index: int) -> Dict:
        """One utterance's artifacts, as tensors on the device."""
        base_dir = dir_info.directory
        silent = dir_info.silent

        raw, before, after = (to_device(x, self.device) for x in
                              load_raw_emg_with_context(base_dir, index))
        emg = pre_process_emg_signal(raw, before, after,
                                     emg_raw_target_sample_rate=800)
        emg_features = get_emg_features(emg, frame_length_samples=26,
                                        hop_length_samples=8, pad=True)

        try:
            audio_path = find_audio_file(base_dir / f"{index}_audio_clean.flac")
        except FileNotFoundError as exc:
            raise FileNotFoundError(
                f"Cleaned audio missing (run ste_gan_torch.clean_audio "
                f"first): {base_dir / f'{index}_audio_clean.flac'}") from exc
        audio = load_audio(audio_path, normalize=True, device=self.device)
        audio = cut_audio_to_soft_speech_match_unit_frame_rate(audio)
        mfccs = self.mfcc_calc(audio)

        if not silent:
            n = min(len(emg_features), len(mfccs))
            emg_features, mfccs = emg_features[:n], mfccs[:n]

        with torch.no_grad():
            speech_units = self.hubert.units(
                audio[None, None].float()).squeeze().detach()

        speech_units, mfccs = align_speech_units_and_mfccs(speech_units, mfccs)
        if not silent:
            emg_features = emg_features[: len(mfccs)]
        else:
            speech_units = None

        if not silent and emg_features.shape[0] != mfccs.shape[0]:
            raise ValueError(f"{base_dir}/{index}: {emg_features.shape[0]} "
                             f"EMG feature frames, {mfccs.shape[0]} MFCCs")
        emg = emg[: 8 * emg_features.shape[0]]
        if emg.shape[0] != emg_features.shape[0] * 8:
            raise ValueError(f"{base_dir}/{index}: {emg.shape[0]} EMG samples "
                             f"for {emg_features.shape[0]} feature frames")

        info = json.loads((base_dir / f"{index}_info.json").read_text())
        sess = base_dir.name
        tg = self.text_align_directory / sess / f"{sess}_{index}_audio.TextGrid"
        num_units = (speech_units.shape[0] if speech_units is not None
                     else mfccs.shape[0] // 2)
        if tg.exists():
            phonemes = read_phonemes(tg, num_units)
        else:
            phonemes = np.full(num_units, PHONEME_INVENTORY.index("sil"),
                               dtype=np.int64)

        return {
            "mfccs": mfccs, "emg_features": emg_features, "text": info["text"],
            "book_location": (info["book"], info["sentence_index"]),
            "phonemes": phonemes, "emg": emg.float(),
            "speech_units": speech_units, "audio": audio,
            "audio_path": audio_path, "silent": silent, "dir_info": dir_info,
            "index": index,
        }

    def __getitem__(self, i: int) -> Dict:
        dir_info, idx = self.example_indices[i]
        sample = self.load_utterance(dir_info, idx)
        # Legacy scaling of the reference prep: /100, then tanh (f32).
        sample["emg"] = torch.tanh(sample["emg"] / 100.0)
        if dir_info.silent:
            # Pull the voiced parallel recording's speech features.
            voiced_dir, voiced_idx = self.voiced_data_locations[
                sample["book_location"]]
            voiced = self.load_utterance(voiced_dir, voiced_idx)
            sample["parallel_speech_units"] = voiced["speech_units"]
            sample["parallel_mfccs"] = voiced["mfccs"]
            sample["parallel_audio"] = voiced["audio"]
            sample["phonemes"] = voiced["phonemes"]
            sample["audio_path"] = voiced["audio_path"]
        return sample

    def utt_file_id(self, sample: Dict) -> str:
        dir_info = sample["dir_info"]
        split = dir_info.directory.parent.name
        mode = SpeakingMode.SILENT if sample["silent"] else SpeakingMode.NORMAL
        return f"{split}_{dir_info.directory.name}__{sample['index']}__{mode}"

    def reference_identifier(self, sample: Dict) -> Tuple[str, str, str]:
        audio_path = Path(sample["audio_path"])
        return (audio_path.parents[1].name, audio_path.parent.name,
                audio_path.stem.split("_")[0])


def silent_reference_ids(prep: GaddyKleinPrep) -> Set[Tuple[str, str, str]]:
    refs = set()
    for i in range(len(prep)):
        sample = prep[i]
        if sample["silent"]:
            refs.add(prep.reference_identifier(sample))
    return refs


def save_samples(prep: GaddyKleinPrep, root: Path, dev_refs: Set,
                 test_refs: Set, emg_sr: int = 800, unit_sr: int = 50,
                 dry_run: bool = False) -> int:
    """Write every sample's artifacts under ``root/{split}``; returns the
    number of utterances."""
    ratio = emg_sr // unit_sr
    for i in range(len(prep)):
        sample = prep[i]
        utt_id = prep.utt_file_id(sample)
        ref = prep.reference_identifier(sample)
        split = "valid" if ref in dev_refs else (
            "test" if ref in test_refs else "train")
        split_dir = root / split

        silent = sample["silent"]
        units = sample["parallel_speech_units"] if silent else sample["speech_units"]
        mfccs = sample["parallel_mfccs"] if silent else sample["mfccs"]
        audio = sample["parallel_audio"] if silent else sample["audio"]
        emg, emg_features = sample["emg"], sample["emg_features"]
        phonemes = sample["phonemes"]

        units, mfccs = align_speech_units_and_mfccs(units, mfccs)
        if not silent:
            n = min(len(mfccs), len(emg_features))
            emg_features, mfccs = emg_features[:n], mfccs[:n]
            units = units[: len(mfccs) // 2]
            emg = emg[: len(units) * ratio]
            if len(units) * ratio != len(emg) or len(emg_features) != 2 * len(units):
                raise ValueError(f"{utt_id}: {len(emg)} EMG samples, "
                                 f"{len(emg_features)} feature frames for "
                                 f"{len(units)} units")
        if len(units) != len(phonemes):
            raise ValueError(f"{utt_id}: {len(units)} units, {len(phonemes)} "
                             f"phonemes")

        artifacts = {
            "emg": emg, "phonemes": phonemes, "units": units,
            "emg_feats": emg_features, "mfccs": mfccs,
        }
        artifacts = {k: _np(v) for k, v in artifacts.items()}
        print(f"{utt_id} -> {split} "
              + " ".join(f"{k}:{v.shape}" for k, v in artifacts.items()))
        if dry_run:
            continue
        for name, data in artifacts.items():
            sub = split_dir / name
            sub.mkdir(parents=True, exist_ok=True)
            np.save(sub / f"{utt_id}.npy", data)
        sub = split_dir / "transcriptions"
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"{utt_id}.txt").write_text(sample["text"])
        sub = split_dir / "audio"
        sub.mkdir(parents=True, exist_ok=True)
        write_audio_file(sub / f"{utt_id}.wav", _np(audio), sample_rate=16_000)
    return len(prep)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source_data_dir", type=Path,
                        default=Path("raw_data/emg_data/"))
    parser.add_argument("--text_alignment_dir", type=Path,
                        default=Path("raw_data/text_alignments/"))
    parser.add_argument("--testset_file", type=Path,
                        default=Path("raw_data/testset_largedev.json"))
    parser.add_argument("--target_dir", type=Path,
                        default=Path("data/gaddy_complete"))
    parser.add_argument("--emg_sr", type=int, default=800)
    parser.add_argument("--unit_sr", type=int, default=50)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to prepare on (default cuda; 'cpu' runs "
                             "the filters' plain versions).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    src = Path(args.source_data_dir)
    silent_dirs = [src / "silent_parallel_data"]
    voiced_dirs = [src / "voiced_parallel_data", src / "nonparallel_data"]

    hubert = load_hubert(device)
    common = dict(silent_dirs=silent_dirs, voiced_dirs=voiced_dirs,
                  text_align_directory=args.text_alignment_dir,
                  testset_file=args.testset_file, hubert=hubert, device=device)

    dev_prep = GaddyKleinPrep(dev=True, **common)
    test_prep = GaddyKleinPrep(test=True, **common)
    dev_refs = silent_reference_ids(dev_prep)
    test_refs = silent_reference_ids(test_prep)
    all_prep = GaddyKleinPrep(no_testset=True, **common)
    return save_samples(all_prep, Path(args.target_dir), dev_refs, test_refs,
                        emg_sr=args.emg_sr, unit_sr=args.unit_sr,
                        dry_run=args.dry_run)


if __name__ == "__main__":
    main()
