"""Device-resident training corpus: the train split on the card, crops
gathered there.

Counterpart of ``ste_gan_tpu/data/device_corpus.py``. The host input
pipeline (loader.py + collate.py) copies ~4 MB of freshly cropped tensors to
the card every step. Here every utterance of the train split goes up ONCE at
startup, padded and stacked, and per step only ``[B]`` int32 crop
descriptors (rows + crop starts) cross; :meth:`DeviceCorpus.gather` cuts the
static-shape training crops on the card. Crop semantics are bit-identical
to :func:`ste_gan_torch.data.collate.ste_gan_collate` (train partition): a
``frames``-frame speech-unit/phoneme crop at ``start``, the paired ``2x``
MFCC crop and ``HOPSIZE x`` EMG crop.

The gather is one advanced-index read per array (row index plus ``start +
arange``), so a batch costs a handful of launches whatever its size.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.utils.profiling import span


class DeviceCorpus:
    """One split's utterances, padded/stacked and resident on ``device``.

    Float arrays are stored in ``float_dtype`` (default f16 — the same
    rounding as the trainer's f16 wire format, so trajectories match the
    host pipeline at equal ``transfer_dtype``). Padding rows lie past every
    legal crop window (train crops start at most at ``len - frames``), so
    gathers never read padding. ``unit_lengths`` are the true (unpadded)
    frame counts, on the host; the :class:`IndexLoader` draws crop starts
    from them."""

    def __init__(self, emg: torch.Tensor, speech_units: torch.Tensor,
                 phonemes: torch.Tensor, mfccs: Optional[torch.Tensor],
                 session_index: torch.Tensor,
                 speaking_mode_index: torch.Tensor, emg_train_length: int,
                 hopsize: int, unit_lengths):
        self.emg = emg                        # [N, Lmax_emg, C] float
        self.speech_units = speech_units      # [N, Lmax, U] float
        self.phonemes = phonemes              # [N, Lmax] int32
        self.mfccs = mfccs                    # [N, 2*Lmax, M] float or None
        self.session_index = session_index    # [N] int32
        self.speaking_mode_index = speaking_mode_index  # [N] int32
        self.emg_train_length = emg_train_length
        self.hopsize = hopsize
        self.unit_lengths = tuple(int(x) for x in unit_lengths)
        device = emg.device
        # Offsets of one crop along time, made once.
        self._frame_offsets = torch.arange(self.frames, device=device)
        self._emg_offsets = torch.arange(emg_train_length, device=device)
        self._mfcc_offsets = torch.arange(2 * self.frames, device=device)

    @property
    def frames(self) -> int:
        return self.emg_train_length // self.hopsize

    @property
    def nbytes(self) -> int:
        arrays = [self.emg, self.speech_units, self.phonemes,
                  self.session_index, self.speaking_mode_index]
        if self.mfccs is not None:
            arrays.append(self.mfccs)
        return sum(a.numel() * a.element_size() for a in arrays)

    # ------------------------------------------------------------------
    @classmethod
    def from_dataset(cls, dataset, emg_train_length: int, device,
                     hopsize: int = C.HOPSIZE,
                     float_dtype: torch.dtype = torch.float16
                     ) -> "DeviceCorpus":
        """Pad/stack every utterance of ``dataset`` and copy it to
        ``device`` once."""
        n = len(dataset)
        if n == 0:
            raise ValueError("cannot build a DeviceCorpus from an empty split")
        items = [dataset[i] for i in range(n)]
        unit_lengths = np.asarray(
            [len(it[C.DataType.SPEECH_UNITS]) for it in items], np.int64)

        lmax = int(unit_lengths.max())
        emg_max = max(max(len(it[C.DataType.REAL_EMG]) for it in items),
                      hopsize * lmax)
        has_mfccs = all(it[C.DataType.MFCCS] is not None for it in items)

        def pad0(a: np.ndarray, length: int) -> np.ndarray:
            out = np.zeros((length,) + a.shape[1:], a.dtype)
            out[: len(a)] = a
            return out

        np_float = {torch.float16: np.float16,
                    torch.float32: np.float32}[float_dtype]
        units = np.stack([pad0(it[C.DataType.SPEECH_UNITS], lmax)
                          for it in items]).astype(np_float)
        phonemes = np.stack([pad0(it[C.DataType.PHONEMES].astype(np.int32), lmax)
                             for it in items])
        emg = np.stack([pad0(it[C.DataType.REAL_EMG], emg_max)
                        for it in items]).astype(np_float)
        mfccs = None
        if has_mfccs:
            mfccs = np.stack([pad0(it[C.DataType.MFCCS], 2 * lmax)
                              for it in items]).astype(np_float)
        session = np.asarray(
            [it[C.DataType.SESSION_INDEX] for it in items], np.int32)
        mode = np.asarray(
            [it[C.DataType.SPEAKING_MODE_INDEX] for it in items], np.int32)

        def put(a):
            return torch.from_numpy(a).to(device)

        return cls(
            emg=put(emg), speech_units=put(units), phonemes=put(phonemes),
            mfccs=put(mfccs) if mfccs is not None else None,
            session_index=put(session), speaking_mode_index=put(mode),
            emg_train_length=emg_train_length, hopsize=hopsize,
            unit_lengths=unit_lengths)

    # ------------------------------------------------------------------
    def gather(self, rows: torch.Tensor, starts: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """Assemble a train batch on the corpus' device.

        ``rows``/``starts`` are ``[B]`` integer tensors on that device;
        output shapes and values match ``ste_gan_collate(items, "train",
        starts=starts)`` for ``items = [dataset[r] for r in rows]`` (modulo
        ``float_dtype``). Runs inside the ``feed/gather`` span."""
        with span("feed/gather"):
            rows = rows.long()
            starts = starts.long()
            r = rows[:, None]
            t = starts[:, None] + self._frame_offsets           # [B, frames]
            batch = {
                C.DataType.SPEECH_UNITS: self.speech_units[r, t],
                C.DataType.PHONEMES: self.phonemes[r, t],
                C.DataType.REAL_EMG: self.emg[
                    r, starts[:, None] * self.hopsize + self._emg_offsets],
                C.DataType.SESSION_INDEX: self.session_index[rows],
                C.DataType.SPEAKING_MODE_INDEX: self.speaking_mode_index[rows],
            }
            if self.mfccs is not None:
                batch[C.DataType.MFCCS] = self.mfccs[
                    r, 2 * starts[:, None] + self._mfcc_offsets]
        return batch


class IndexLoader:
    """Train-partition view of a :class:`~ste_gan_torch.data.loader.DataLoader`
    that yields crop descriptors (``{"rows", "starts"}`` int32 ``[B]``)
    instead of collated tensors — the host half of the device-resident path.

    Epoch/shuffle/crop-start state is the WRAPPED loader's own (same seeded
    permutation, same per-(seed, epoch, global-index) crop starts), so a run
    is example-for-example identical to the host-collate pipeline."""

    def __init__(self, loader, unit_lengths):
        if loader.partition != "train":
            raise ValueError("index batches are a train-only path")
        self._loader = loader
        self._unit_lengths = np.asarray(unit_lengths, np.int64)
        if len(self._unit_lengths) != len(loader.dataset):
            raise ValueError(f"{len(self._unit_lengths)} unit lengths for "
                             f"{len(loader.dataset)} utterances")

    @property
    def dataset(self):
        return self._loader.dataset

    def __len__(self) -> int:
        return len(self._loader)

    def skip_epochs(self, n: int) -> None:
        self._loader.skip_epochs(n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_epoch()

    def iter_epoch(self, skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        ld = self._loader
        for local in ld._epoch_chunks(skip):
            starts = ld._crop_starts(local, self._unit_lengths[local])
            yield {"rows": local.astype(np.int32),
                   "starts": starts.astype(np.int32)}
