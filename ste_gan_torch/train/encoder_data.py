"""Batching for EMG-encoder pre-training: size-aware packing and fixed-shape
window folding (counterpart of ``ste_gan_tpu/train/encoder_data.py``).

The reference packs utterances into batches bounded by total EMG samples
(SizeAwareSampler, ste_gan/emg_encoder/utils.py:182-200), concatenates each
batch and folds it into windows of ``SEQ_LEN*8 = 1600`` EMG samples
(combine_fixed_length, :93-104). As in the JAX package the fold is padded to
a fixed window count and each 50 Hz frame carries the index of the utterance
it belongs to (-1 for padding), so the per-sample loss loop becomes indexed
sums. Padded windows stay in the batch: they count in the BatchNorm
statistics in both packages.

:class:`EncoderDeviceCorpus` keeps a split on the card and folds a batch
there from a ``{rows, num_samples}`` descriptor; its fold equals
:func:`fold_encoder_batch` field for field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import emg_encoder_constants as EC
from ste_gan_torch.utils.profiling import span


class SizeAwareSampler:
    """Shuffled greedy packing of utterance indices with a total-EMG-sample
    budget per batch; the last incomplete batch is dropped (reference
    semantics). The same ``np.random.default_rng(seed)`` stream as the JAX
    package's sampler, so the batches are identical."""

    def __init__(self, lengths: Sequence[int], max_len: int = EC.TRAIN_BATCH_MAX_LEN,
                 seed: int = 0):
        self.lengths = list(lengths)
        self.max_len = max_len
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[List[int]]:
        indices = np.arange(len(self.lengths))
        self._rng.shuffle(indices)
        batch: List[int] = []
        batch_length = 0
        for idx in indices:
            length = self.lengths[idx]
            if length + batch_length > self.max_len:
                yield batch
                batch = []
                batch_length = 0
            batch.append(int(idx))
            batch_length += length
        # last incomplete batch dropped


@dataclasses.dataclass
class EncoderBatch:
    """Fixed-shape folded batch (numpy)."""

    emg_windows: np.ndarray      # [n_win, window, C]
    su_targets: np.ndarray       # [n_win * frames_per_win, 256]
    ph_targets: np.ndarray       # [n_win * frames_per_win]
    frame_sample_id: np.ndarray  # [n_win * frames_per_win] int32, -1 = pad
    silent: np.ndarray           # [max_samples] bool
    num_samples: np.ndarray      # [] int32

    # Silent-sample DTW targets (present only when the fold is built with
    # ``max_silent > 0``; silent targets come from the PARALLEL voiced
    # recording and have a different length from the prediction frames).
    silent_su_targets: np.ndarray = None   # [max_silent, t_target_max, 256]
    silent_ph_targets: np.ndarray = None   # [max_silent, t_target_max] int32
    silent_target_len: np.ndarray = None   # [max_silent] int32 (0 = empty slot)
    silent_pred_start: np.ndarray = None   # [max_silent] int32 (flat frame axis)
    silent_pred_len: np.ndarray = None     # [max_silent] int32

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


def fold_encoder_batch(
    items: Sequence[Dict],
    seq_len: int = EC.SEQ_LEN,
    n_win: int = None,
    max_samples: int = None,
    emg_ratio: int = EC.EMG_SIGNAL_TO_SPEECH_UNITS,
    max_silent: int = 0,
    silent_target_frames: int = 0,
    silent_pred_frames: int = 0,
) -> EncoderBatch:
    """Concatenate utterances, fold into fixed windows, build frame->sample
    ids. ``n_win`` defaults to the packing budget's worst case.

    ``max_silent > 0`` also emits fixed-shape DTW targets for the silent
    samples (mixed-batch training; reference
    ste_gan/emg_encoder/train.py:120-144): each silent sample's padded
    speech-unit/phoneme targets plus its prediction-frame slice on the
    flattened 50 Hz frame axis."""
    window = seq_len * 8
    frames_per_win = window // emg_ratio
    if n_win is None:
        n_win = math.ceil(EC.TRAIN_BATCH_MAX_LEN / window) + 1
    if max_samples is None:
        max_samples = max(len(items), 2 * n_win)

    emg_list = [np.asarray(it[C.DataType.REAL_EMG], np.float32) for it in items]
    su_list = [np.asarray(it[C.DataType.SPEECH_UNITS], np.float32) for it in items]
    ph_list = [np.asarray(it[C.DataType.PHONEMES], np.int32) for it in items]
    silent_flags = [it[C.DataType.SPEAKING_MODE_ID] != C.SpeakingMode.NORMAL
                    for it in items]

    total = sum(len(e) for e in emg_list)
    num_channels = emg_list[0].shape[-1]
    capacity = n_win * window
    if total > capacity:
        raise ValueError(f"batch of {total} EMG samples exceeds capacity "
                         f"{capacity} ({n_win} windows)")
    if len(items) > max_samples:
        raise ValueError(f"{len(items)} utterances > max_samples {max_samples}")

    emg = np.zeros((capacity, num_channels), np.float32)
    emg[:total] = np.concatenate(emg_list, axis=0)
    emg_windows = emg.reshape(n_win, window, num_channels)

    # Prediction frames per utterance derive from the EMG length. A silent
    # sample's targets come from the parallel voiced recording with another
    # length: its frames get zero targets here (the silent mask keeps them
    # out of the voiced loss) and its DTW targets go to a slot.
    frame_capacity = n_win * frames_per_win
    su = np.zeros((frame_capacity, su_list[0].shape[-1]), np.float32)
    ph = np.zeros((frame_capacity,), np.int32)
    sample_id = np.full((frame_capacity,), -1, np.int32)

    silent_fields = {}
    if max_silent > 0:
        dim = su_list[0].shape[-1]
        silent_fields = {
            "silent_su_targets": np.zeros(
                (max_silent, silent_target_frames, dim), np.float32),
            "silent_ph_targets": np.zeros(
                (max_silent, silent_target_frames), np.int32),
            "silent_target_len": np.zeros((max_silent,), np.int32),
            "silent_pred_start": np.zeros((max_silent,), np.int32),
            "silent_pred_len": np.zeros((max_silent,), np.int32),
        }

    offset = 0
    slot = 0
    for k, (emg_utt, su_utt, ph_utt, silent) in enumerate(
            zip(emg_list, su_list, ph_list, silent_flags)):
        pred_frames = len(emg_utt) // emg_ratio
        sample_id[offset:offset + pred_frames] = k
        if not silent:
            if len(su_utt) != pred_frames:
                raise ValueError(
                    f"voiced sample {k}: {len(su_utt)} target frames vs "
                    f"{pred_frames} prediction frames")
            su[offset:offset + pred_frames] = su_utt
            ph[offset:offset + pred_frames] = ph_utt
        elif max_silent > 0:
            if slot >= max_silent:
                raise ValueError(
                    f"batch has more than max_silent={max_silent} silent samples")
            t_target = len(su_utt)
            if t_target > silent_target_frames:
                raise ValueError(
                    f"silent sample {k}: {t_target} target frames > "
                    f"silent_target_frames={silent_target_frames}")
            if pred_frames > silent_pred_frames:
                raise ValueError(
                    f"silent sample {k}: {pred_frames} prediction frames > "
                    f"silent_pred_frames={silent_pred_frames}")
            silent_fields["silent_su_targets"][slot, :t_target] = su_utt
            silent_fields["silent_ph_targets"][slot, :t_target] = ph_utt
            silent_fields["silent_target_len"][slot] = t_target
            silent_fields["silent_pred_start"][slot] = offset
            silent_fields["silent_pred_len"][slot] = pred_frames
            slot += 1
        offset += pred_frames

    silent = np.zeros((max_samples,), bool)
    silent[: len(items)] = silent_flags

    return EncoderBatch(
        emg_windows=emg_windows,
        su_targets=su,
        ph_targets=ph,
        frame_sample_id=sample_id,
        silent=silent,
        num_samples=np.int32(len(items)),
        **silent_fields,
    )


def windows_needed(lengths: Sequence[int], seq_len: int = EC.SEQ_LEN) -> int:
    window = seq_len * 8
    return math.ceil(sum(lengths) / window)


class EncoderDeviceCorpus:
    """A split on the device as flat concatenated arrays (no padding) plus
    per-utterance ``[N]`` int32 metadata; :meth:`fold` rebuilds the whole
    folded batch there, silent DTW slots included, from ``{rows,
    num_samples}``. The batch's concatenation offsets are a ``cumsum`` of
    the selected lengths, position -> utterance is a
    ``searchsorted(right=True)`` against them, and each folded stream is one
    gather from the flat corpus. Nothing in the fold waits for the host.

    Floats are stored in ``float_dtype`` (f16 by default, the JAX trainer's
    default storage, so both packages see the same quantised inputs)."""

    def __init__(self, dataset, emg_ratio: int = EC.EMG_SIGNAL_TO_SPEECH_UNITS,
                 float_dtype: torch.dtype = torch.float16, device=None):
        n = len(dataset)
        if n == 0:
            raise ValueError("cannot build an EncoderDeviceCorpus from an "
                             "empty split")
        items = [dataset[i] for i in range(n)]
        emg_list = [np.asarray(it[C.DataType.REAL_EMG], np.float32)
                    for it in items]
        su_list = [np.asarray(it[C.DataType.SPEECH_UNITS], np.float32)
                   for it in items]
        ph_list = [np.asarray(it[C.DataType.PHONEMES], np.int32)
                   for it in items]
        silent_flags = np.asarray(
            [it[C.DataType.SPEAKING_MODE_ID] != C.SpeakingMode.NORMAL
             for it in items], bool)
        for k, (e, s) in enumerate(zip(emg_list, su_list)):
            if not silent_flags[k] and len(s) != len(e) // emg_ratio:
                raise ValueError(
                    f"voiced sample {k}: {len(s)} target frames vs "
                    f"{len(e) // emg_ratio} prediction frames")

        self.emg_ratio = emg_ratio
        emg_lens = np.asarray([len(e) for e in emg_list], np.int64)
        fr_lens = np.asarray([len(s) for s in su_list], np.int64)
        self.max_target_frames = int(fr_lens.max())

        # Flat corpora; the target tracks are padded at the tail by the
        # longest utterance so fixed-size silent-slot slices stay in range.
        emg_flat = np.concatenate(emg_list, axis=0)
        su_flat = np.concatenate(
            su_list + [np.zeros((self.max_target_frames, su_list[0].shape[-1]),
                                np.float32)], axis=0)
        ph_flat = np.concatenate(
            ph_list + [np.zeros((self.max_target_frames,), np.int32)])

        def put(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=device, dtype=dtype)

        self.emg_flat = put(emg_flat, float_dtype)
        self.su_flat = put(su_flat, float_dtype)
        self.ph_flat = put(ph_flat)
        self.emg_start = put(np.concatenate([[0], np.cumsum(emg_lens)[:-1]]))
        self.emg_len = put(emg_lens)
        self.fr_start = put(np.concatenate([[0], np.cumsum(fr_lens)[:-1]]))
        self.fr_len = put(fr_lens)
        self.silent_flag = put(silent_flags)

    @property
    def nbytes(self) -> int:
        arrays = (self.emg_flat, self.su_flat, self.ph_flat, self.emg_start,
                  self.emg_len, self.fr_start, self.fr_len, self.silent_flag)
        return sum(a.numel() * a.element_size() for a in arrays)

    def fold(self, rows: torch.Tensor, num_samples: torch.Tensor, *,
             seq_len: int = EC.SEQ_LEN, n_win: int, max_samples: int,
             max_silent: int = 0, silent_target_frames: int = 0
             ) -> Dict[str, torch.Tensor]:
        """The folded batch of ``fold_encoder_batch([dataset[r] for r in
        rows[:num_samples]], ...)`` on the corpus's device, field for field
        (floats in the corpus's ``float_dtype``). ``rows`` is
        ``[max_samples]`` int (entries past ``num_samples`` ignored),
        ``num_samples`` a 0-d int tensor. Runs inside the ``enc/fold``
        span."""
        with span("enc/fold"):
            dev = self.emg_len.device
            window = seq_len * 8
            ratio = self.emg_ratio
            frames_per_win = window // ratio

            num = num_samples.to(dev, torch.int64)
            arange_b = torch.arange(max_samples, device=dev)
            valid = arange_b < num
            r = torch.where(valid, rows.to(dev, torch.int64), 0)

            # EMG stream: batch offsets by cumsum, position -> sample by
            # searchsorted, one gather from the flat corpus.
            e_len = torch.where(valid, self.emg_len[r], 0)
            cum = torch.cat([e_len.new_zeros(1), torch.cumsum(e_len, 0)])
            total = cum[-1]
            pos = torch.arange(n_win * window, device=dev)
            k = (torch.searchsorted(cum, pos, right=True) - 1).clamp(
                0, max_samples - 1)
            idx = self.emg_start[r][k] + (pos - cum[k])
            in_range = pos < total
            emg = self.emg_flat[idx.clamp(0, self.emg_flat.shape[0] - 1)]
            emg = torch.where(in_range[:, None], emg, 0)
            emg_windows = emg.reshape(n_win, window, -1)

            # The flattened 50 Hz frame axis: the same at frame granularity.
            p_len = e_len // ratio
            fcum = torch.cat([p_len.new_zeros(1), torch.cumsum(p_len, 0)])
            fpos = torch.arange(n_win * frames_per_win, device=dev)
            fk = (torch.searchsorted(fcum, fpos, right=True) - 1).clamp(
                0, max_samples - 1)
            f_in = fpos < fcum[-1]
            frame_sample_id = torch.where(f_in, fk, -1).to(torch.int32)

            sil = valid & self.silent_flag[r]
            voiced_frame = f_in & ~sil[fk]
            fidx = (self.fr_start[r][fk] + (fpos - fcum[fk])).clamp(
                0, self.su_flat.shape[0] - 1)
            su = torch.where(voiced_frame[:, None], self.su_flat[fidx], 0)
            ph = torch.where(voiced_frame, self.ph_flat[fidx], 0)

            batch = {
                "emg_windows": emg_windows,
                "su_targets": su,
                "ph_targets": ph.to(torch.int32),
                "frame_sample_id": frame_sample_id,
                "silent": sil,
                "num_samples": num.to(torch.int32),
            }
            if max_silent > 0:
                # Scatter the batch's silent samples into fixed slots in batch
                # order; updates aimed past the last slot land in a spare one
                # that is cut off (``mode="drop"`` in the JAX fold).
                slot = torch.cumsum(sil.long(), 0) - 1
                tgt = torch.where(sil, slot, max_silent).clamp(max=max_silent)

                def scat(vals):
                    out = vals.new_zeros(max_silent + 1)
                    return out.scatter_(0, tgt, vals)[:max_silent]

                slot_row = scat(r)
                slot_active = scat(sil.long()).bool()
                t_len = torch.where(slot_active, self.fr_len[slot_row], 0)
                t_idx = torch.arange(silent_target_frames, device=dev)
                sidx = (self.fr_start[slot_row][:, None] + t_idx).clamp(
                    0, self.su_flat.shape[0] - 1)
                keep = t_idx[None, :] < t_len[:, None]
                batch.update({
                    "silent_su_targets": torch.where(keep[..., None],
                                                     self.su_flat[sidx], 0),
                    "silent_ph_targets": torch.where(keep, self.ph_flat[sidx],
                                                     0).to(torch.int32),
                    "silent_target_len": t_len.to(torch.int32),
                    "silent_pred_start": scat(fcum[:-1]).to(torch.int32),
                    "silent_pred_len": scat(p_len).to(torch.int32),
                })
        return batch
