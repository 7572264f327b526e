"""EMG dataset: per-utterance artifact reader with filtering, session
vocabularies, and an in-RAM cache.

Behavioural parity with the reference EMGDataset
(ste_gan/data/emg_dataset.py:13-294):

* utterances are discovered from the ``emg/`` subdir, sorted by filename;
* train/valid drop utterances shorter than the training chunk
  (``filter_by_length``), test never filters by length;
* voiced-only / silent-only filters act on the speaking mode encoded in the
  utterance id (``{session}__{name}__{mode}``);
* session / speaking-mode vocabularies are derived from the *train* split
  (sorted unique ids) and passed to valid/test so embedding indices agree;
* ``strict`` asserts ``len(emg) == 16 * len(units) == 16 * len(phonemes)``;
* items are memoised in RAM after first load (the reference lru_caches
  ``__getitem__``);
* ``check_no_data_overlap`` raises on utterance-id overlap across splits;
* vocabularies can be saved as JSON next to checkpoints (required to
  reproduce embedding indices at inference).

Artifacts are ``.npy`` (our ETL) with a ``.pt`` fallback (torch-format
corpora produced by the reference's prep scripts). This is the port's own
copy of ``ste_gan_tpu/data/dataset.py``: the same files give the same items.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ste_gan_torch import constants as C


def _load_array(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".pt":
        t = torch.load(path, map_location="cpu", weights_only=True)
        return t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    raise ValueError(f"unsupported artifact format: {path}")


def _find_artifact(directory: Path, stem: str) -> Path:
    for suffix in (".npy", ".pt"):
        candidate = directory / f"{stem}{suffix}"
        if candidate.exists():
            return candidate
    raise FileNotFoundError(f"no artifact {stem}.npy/.pt in {directory}")


def utt_id_to_session_id(utt_id: str) -> str:
    return utt_id.split("__")[0]


def utt_id_to_speaking_mode(utt_id: str) -> str:
    return utt_id.split("__")[-1]


class EMGDataset:
    """Reads per-utterance EMG + parallel-speech artifacts for one split."""

    def __init__(
        self,
        root_dir: Path,
        partition: str = "train",
        session_id_to_idx: Optional[Dict[str, int]] = None,
        speaking_mode_id_to_idx: Optional[Dict[str, int]] = None,
        only_include_voiced: bool = True,
        only_include_silent: bool = False,
        filter_by_length: bool = True,
        strict: bool = False,
        return_mfccs: bool = True,
        return_emg_feats: bool = True,
        train_emg_length: int = C.TRAIN_EMG_LENGTH,
        cache: bool = True,
    ):
        assert not (only_include_silent and only_include_voiced), (
            "Either only_include_silent or only_include_voiced can be True.")
        C.Partition.check(partition)
        self.partition = partition
        self.root_dir = Path(root_dir)
        self.split_dir = self.root_dir / partition
        self.strict = strict
        self.return_mfccs = return_mfccs
        self.return_emg_feats = return_emg_feats
        self.train_emg_length = train_emg_length
        self._cache: Optional[Dict[int, Dict]] = {} if cache else None

        # Packed single-file split (data/packed.py): lengths/channels come
        # from the index (zero startup IO), arrays from one mmap. Items
        # are identical to the directory layout's (tests/test_packed.py).
        from ste_gan_torch.data.packed import PackedSplit
        self._packed = PackedSplit.maybe_open(self.split_dir)

        is_test = partition == "test"
        emg_dir = self.split_dir / C.DataDir.EMG
        if self._packed is not None:
            candidates = [(emg_dir / f"{utt}.npy", length)
                          for utt, length in self._packed.emg_infos()]
        else:
            paths = sorted(list(emg_dir.glob("*.npy"))
                           + list(emg_dir.glob("*.pt")))
            candidates = [(p, len(_load_array(p))) for p in paths]

        self.emg_paths: List[Path] = []
        self.emg_lengths: List[int] = []
        num_filtered = 0
        for emg_path, emg_len in candidates:
            if filter_by_length and emg_len < train_emg_length and not is_test:
                num_filtered += 1
                continue
            mode = utt_id_to_speaking_mode(emg_path.stem)
            is_silent = mode != C.SpeakingMode.NORMAL
            if (only_include_voiced and is_silent) or (only_include_silent and not is_silent):
                num_filtered += 1
                continue
            self.emg_paths.append(emg_path)
            self.emg_lengths.append(emg_len)
        self.num_filtered = num_filtered
        logging.info("Partition %s: %d utterances (%d filtered)", partition,
                     len(self.emg_paths), num_filtered)

        self.utt_ids = [p.stem for p in self.emg_paths]
        if self._packed is not None:
            self.transcripts = [self._packed.transcription(utt)
                                for utt in self.utt_ids]
        else:
            self.transcripts = [
                (self.split_dir / C.DataDir.TRANSCRIPTIONS / f"{utt}.txt")
                .read_text().strip().lower()
                if (self.split_dir / C.DataDir.TRANSCRIPTIONS / f"{utt}.txt").exists()
                else ""
                for utt in self.utt_ids
            ]

        self.session_ids = [utt_id_to_session_id(u) for u in self.utt_ids]
        self.speaking_mode_ids = [utt_id_to_speaking_mode(u) for u in self.utt_ids]

        self.session_id_to_idx = session_id_to_idx or {
            sid: i for i, sid in enumerate(sorted(set(self.session_ids)))}
        self.speaking_mode_id_to_idx = speaking_mode_id_to_idx or {
            mid: i for i, mid in enumerate(sorted(set(self.speaking_mode_ids)))}

        self.session_indices = [self.session_id_to_idx[s] for s in self.session_ids]
        self.speaking_mode_indices = [
            self.speaking_mode_id_to_idx[m] for m in self.speaking_mode_ids]

        self.session_idx_to_id = {v: k for k, v in self.session_id_to_idx.items()}
        self.speaking_mode_idx_to_id = {
            v: k for k, v in self.speaking_mode_id_to_idx.items()}

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.utt_ids)

    @property
    def num_sessions(self) -> int:
        return len(self.session_idx_to_id)

    @property
    def num_speaking_modes(self) -> int:
        return len(self.speaking_mode_id_to_idx)

    @property
    def num_emg_channels(self) -> int:
        if self._packed is not None:
            return self._packed.num_emg_channels
        if not self.emg_paths:
            raise RuntimeError("empty dataset — cannot determine channel count")
        return int(_load_array(self.emg_paths[0]).shape[-1])

    def save_session_and_speaking_mode_mapping_json(self, save_dir: Path) -> None:
        save_dir = Path(save_dir)
        (save_dir / "session_idx_to_id.json").write_text(
            json.dumps(self.session_idx_to_id))
        (save_dir / "speaking_mode_idx_to_id.json").write_text(
            json.dumps(self.speaking_mode_idx_to_id))

    @staticmethod
    def check_no_data_overlap(datasets: Sequence["EMGDataset"]) -> None:
        sets = [set(ds.utt_ids) for ds in datasets]
        overlap = set.intersection(*sets)
        if overlap:
            raise ValueError(f"Intersecting utterance ids: {','.join(overlap)}")

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict:
        if self._cache is not None and index in self._cache:
            return self._cache[index]

        emg_path = self.emg_paths[index]
        stem = emg_path.stem

        def field(name: str, directory: str, dtype) -> np.ndarray:
            if self._packed is not None:
                return np.asarray(self._packed.load(stem, name), dtype)
            if name == "emg":
                return np.asarray(_load_array(emg_path), dtype)
            return np.asarray(_load_array(
                _find_artifact(self.split_dir / directory, stem)), dtype)

        real_emg = field("emg", C.DataDir.EMG, np.float32)
        units = field("units", C.DataDir.SPEECH_UNITS, np.float32)
        phonemes = field("phonemes", C.DataDir.PHONEMES, np.int32)

        mfccs = None
        if self.return_mfccs:
            mfccs = field("mfccs", C.DataDir.MFCCS, np.float32)
        emg_feats = None
        if self.return_emg_feats:
            try:
                emg_feats = field("emg_feats", C.DataDir.EMG_FEATS, np.float32)
            except FileNotFoundError:
                emg_feats = None

        if self.strict:
            assert len(units) == len(phonemes)
            # Silent utterances carry targets from the PARALLEL voiced
            # recording with an unrelated length; the prep pipeline only
            # guarantees the 16x invariant for voiced samples (reference
            # scripts/prep_data_gaddy_and_klein.py:386-407).
            if self.speaking_mode_ids[index] == C.SpeakingMode.NORMAL:
                assert len(real_emg) == C.HOPSIZE * len(units)
                assert len(real_emg) == C.HOPSIZE * len(phonemes)

        item = {
            C.DataType.UTT_ID: self.utt_ids[index],
            C.DataType.TRANSCRIPTION: self.transcripts[index],
            C.DataType.REAL_EMG: real_emg,
            C.DataType.PHONEMES: phonemes,
            C.DataType.SPEECH_UNITS: units,
            C.DataType.SESSION_ID: self.session_ids[index],
            C.DataType.SESSION_INDEX: np.int32(self.session_indices[index]),
            C.DataType.SPEAKING_MODE_ID: self.speaking_mode_ids[index],
            C.DataType.SPEAKING_MODE_INDEX: np.int32(self.speaking_mode_indices[index]),
            C.DataType.MFCCS: mfccs,
            C.DataType.EMG_FEATURES: emg_feats,
        }
        if self._cache is not None:
            self._cache[index] = item
        return item
