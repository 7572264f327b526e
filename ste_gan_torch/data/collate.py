"""Batch assembly with static shapes.

Parity with the reference collate (ste_gan/data/collate.py:22-157):

* train: a random 128-frame speech-unit crop per utterance (paired 2x MFCC
  crop and 16x EMG crop), giving fixed [B, 128, 256] / [B, 256, 25] /
  [B, 2048, 8] batches;
* valid: the deterministic first chunk of each utterance;
* test: the single full-length utterance, batch size 1.

Static shapes by construction: every train step sees one batch shape, with
no padding. Randomness comes from a ``numpy.random.Generator`` threaded by
the caller (the input pipeline is host-side). This is the port's own copy of
``ste_gan_tpu/data/collate.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ste_gan_torch import constants as C


def ste_gan_collate(
    batch: Sequence[Dict],
    partition: str = "train",
    emg_train_length: int = C.TRAIN_EMG_LENGTH,
    hopsize: int = C.HOPSIZE,
    rng: Optional[np.random.Generator] = None,
    starts: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """``starts`` (train only): externally chosen per-item crop starts in
    speech-unit frames — the multi-host loader derives them from
    (seed, epoch, global item index) so crops are identical no matter how
    the global batch is partitioned across hosts."""
    C.Partition.check(partition)
    length = emg_train_length // hopsize

    units_list = [s[C.DataType.SPEECH_UNITS] for s in batch]
    phoneme_list = [s[C.DataType.PHONEMES] for s in batch]
    mfcc_list = [s[C.DataType.MFCCS] for s in batch]
    emg_list = [s[C.DataType.REAL_EMG] for s in batch]

    session_idx = np.asarray(
        [s[C.DataType.SESSION_INDEX] for s in batch], np.int32)
    mode_idx = np.asarray(
        [s[C.DataType.SPEAKING_MODE_INDEX] for s in batch], np.int32)

    if partition == "train":
        if starts is None:
            if rng is None:
                rng = np.random.default_rng()
            starts = np.asarray([
                rng.integers(0, 1 + max(0, len(u) - length))
                for u in units_list], np.int64)
        else:
            starts = np.asarray(starts, np.int64)
            assert len(starts) == len(batch)
    elif partition == "valid":
        starts = np.zeros(len(batch), np.int64)
    else:  # test: single full-length utterance
        assert len(batch) == 1
        return {
            C.DataType.REAL_EMG: emg_list[0][None],
            C.DataType.SPEECH_UNITS: units_list[0][None],
            C.DataType.PHONEMES: phoneme_list[0][None],
            C.DataType.SESSION_INDEX: session_idx,
            C.DataType.SPEAKING_MODE_INDEX: mode_idx,
            C.DataType.MFCCS: None if mfcc_list[0] is None else mfcc_list[0][None],
        }

    units = np.stack([u[s:s + length] for u, s in zip(units_list, starts)])
    phonemes = np.stack([p[s:s + length] for p, s in zip(phoneme_list, starts)])
    if any(m is None for m in mfcc_list):
        mfccs = None
    else:
        mfccs = np.stack([m[2 * s:2 * s + 2 * length]
                          for m, s in zip(mfcc_list, starts)])
    emg_starts = starts * hopsize
    emg = np.stack([e[s:s + emg_train_length]
                    for e, s in zip(emg_list, emg_starts)])

    return {
        C.DataType.REAL_EMG: emg,
        C.DataType.SPEECH_UNITS: units,
        C.DataType.PHONEMES: phonemes,
        C.DataType.SESSION_INDEX: session_idx,
        C.DataType.SPEAKING_MODE_INDEX: mode_idx,
        C.DataType.MFCCS: mfccs,
    }
