"""Packed single-file corpus format: one mmap-able blob + JSON index per
split — the ArrayRecord/Grain-style source SURVEY §2.1 maps the reference's
per-utterance ``torch.load`` dataset onto.

Why: the directory layout stores ~5 small files per utterance (the
reference's layout, which `EMGDataset` reads directly), so a real corpus
is tens of thousands of inodes, and dataset startup must open every EMG
file just to learn its length (the reference has the same hot startup —
ste_gan/data/emg_dataset.py:65). The packed format is:

    {split}/packed.bin          — all arrays, 64-byte aligned, concatenated
    {split}/packed.index.json   — {utt_id: {field: {offset, shape, dtype}},
                                   transcription} + format metadata

Reads go through one ``mmap`` (zero-copy until touched, shared pages
across processes); lengths/channels come from the index, so startup does
no data IO at all. `EMGDataset` auto-detects a packed split and serves
the IDENTICAL item dicts (`tests/test_packed.py` asserts equality
item-for-item), so every consumer — loaders, device-resident corpus,
trainers — works unchanged.

Convert a split (or a whole corpus) in place:

    python -m ste_gan_torch.data.packed --root data/synthetic [--splits train]

The source directory layout can be ``.npy`` or the reference's ``.pt``
artifacts (same loader). The original files are left untouched; delete
the field directories after packing if the inodes matter.

This is the port's own copy of ``ste_gan_tpu/data/packed.py``; both write
and read the same files.
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ste_gan_torch import constants as C

_BIN = "packed.bin"
_INDEX = "packed.index.json"
_ALIGN = 64

#: packed field name -> artifact directory of the unpacked layout
FIELDS = {
    "emg": C.DataDir.EMG,
    "units": C.DataDir.SPEECH_UNITS,
    "phonemes": C.DataDir.PHONEMES,
    "mfccs": C.DataDir.MFCCS,
    "emg_feats": C.DataDir.EMG_FEATS,
}
_REQUIRED = ("emg", "units", "phonemes")


def pack_split(split_dir: Path, out_dir: Optional[Path] = None) -> Path:
    """Convert one split from the directory layout to the packed format.
    Returns the directory containing ``packed.bin``/``packed.index.json``
    (``out_dir``, default: the split dir itself)."""
    from ste_gan_torch.data.dataset import _find_artifact, _load_array

    split_dir = Path(split_dir)
    out_dir = Path(out_dir) if out_dir else split_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    emg_dir = split_dir / C.DataDir.EMG
    emg_paths = sorted(list(emg_dir.glob("*.npy")) + list(emg_dir.glob("*.pt")))
    if not emg_paths:
        raise FileNotFoundError(f"no EMG artifacts under {emg_dir}")

    index: Dict = {"version": 1, "utterances": {}}
    with (out_dir / _BIN).open("wb") as blob:
        offset = 0
        for emg_path in emg_paths:
            stem = emg_path.stem
            entry: Dict = {}
            for field, directory in FIELDS.items():
                try:
                    arr = np.asarray(_load_array(
                        _find_artifact(split_dir / directory, stem)))
                except FileNotFoundError:
                    if field in _REQUIRED:
                        raise
                    continue
                if field == "phonemes":
                    arr = arr.astype(np.int32)
                elif arr.dtype != np.float32:
                    arr = arr.astype(np.float32)
                pad = -offset % _ALIGN
                blob.write(b"\0" * pad)
                offset += pad
                raw = np.ascontiguousarray(arr).tobytes()
                blob.write(raw)
                entry[field] = {"offset": offset,
                                "shape": list(arr.shape),
                                "dtype": str(arr.dtype)}
                offset += len(raw)
            txt = split_dir / C.DataDir.TRANSCRIPTIONS / f"{stem}.txt"
            entry["transcription"] = (txt.read_text().strip().lower()
                                      if txt.exists() else "")
            index["utterances"][stem] = entry
    (out_dir / _INDEX).write_text(json.dumps(index))
    logging.info("packed %d utterances -> %s (%.1f MB)",
                 len(index["utterances"]), out_dir / _BIN,
                 (out_dir / _BIN).stat().st_size / 2**20)
    return out_dir


class PackedSplit:
    """mmap reader over one packed split."""

    def __init__(self, split_dir: Path):
        split_dir = Path(split_dir)
        index = json.loads((split_dir / _INDEX).read_text())
        if index.get("version") != 1:
            raise ValueError(f"unknown packed-corpus version in "
                             f"{split_dir / _INDEX}: {index.get('version')}")
        self.utterances: Dict[str, Dict] = index["utterances"]
        self._blob = np.memmap(split_dir / _BIN, dtype=np.uint8, mode="r")

    @staticmethod
    def maybe_open(split_dir: Path) -> Optional["PackedSplit"]:
        return (PackedSplit(split_dir)
                if (Path(split_dir) / _INDEX).exists() else None)

    def emg_infos(self) -> List[Tuple[str, int]]:
        """(utt_id, emg_length) for every utterance — sorted by utt_id,
        matching the directory layout's sorted glob — with zero data IO."""
        return sorted((utt, entry["emg"]["shape"][0])
                      for utt, entry in self.utterances.items())

    @property
    def num_emg_channels(self) -> int:
        first = next(iter(self.utterances.values()))
        return int(first["emg"]["shape"][-1])

    def transcription(self, utt_id: str) -> str:
        return self.utterances[utt_id]["transcription"]

    def has_field(self, utt_id: str, field: str) -> bool:
        return field in self.utterances[utt_id]

    def load(self, utt_id: str, field: str) -> np.ndarray:
        """Zero-copy view into the mmap (copy with ``np.asarray`` if you
        need to mutate)."""
        meta = self.utterances[utt_id].get(field)
        if meta is None:
            raise FileNotFoundError(
                f"packed corpus has no '{field}' for {utt_id}")
        dtype = np.dtype(meta["dtype"])
        count = int(np.prod(meta["shape"])) if meta["shape"] else 1
        start = meta["offset"]
        flat = np.frombuffer(self._blob, dtype=dtype, count=count,
                             offset=start)
        return flat.reshape(meta["shape"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", type=Path, required=True,
                    help="corpus root containing {train,valid,test}/")
    ap.add_argument("--splits", nargs="*",
                    default=["train", "valid", "test"])
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    for split in args.splits:
        split_dir = args.root / split
        if not split_dir.is_dir():
            logging.warning("skipping missing split %s", split_dir)
            continue
        pack_split(split_dir)


if __name__ == "__main__":
    main()
