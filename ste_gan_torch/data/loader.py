"""Host-side data loaders with background prefetch, and the host-to-device
copy of their batches.

Counterpart of ``ste_gan_tpu/data/loader.py`` (the reference's DataLoader
setup, ste_gan/data/loader.py:19-109): a shuffling train iterator with
random chunk collation, a sequential valid iterator with first-chunk
collation, and a batch-1 full-length test iterator. Batches are assembled on
the host as numpy (items are RAM-cached after first touch) and handed to a
small thread-based prefetcher; :func:`to_device` moves them to the card
through pinned memory without waiting for the copy.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.data.collate import ste_gan_collate
from ste_gan_torch.data.dataset import EMGDataset


class DataLoader:
    """Iterable over collated batches of an :class:`EMGDataset`.

    ``process_count > 1`` makes every process draw the SAME seeded global
    permutation and batch boundaries, but load/collate only its own
    ``batch_size / process_count`` slice of each global batch.
    ``process_count == 1`` (default) is the unsharded behaviour."""

    def __init__(self, dataset: EMGDataset, batch_size: int, partition: str,
                 shuffle: bool, emg_train_length: int, hopsize: int = C.HOPSIZE,
                 seed: int = 0, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(
                    f"global batch_size {batch_size} not divisible by "
                    f"process_count {process_count}")
            if not drop_last:
                raise ValueError("per-process sharding requires drop_last "
                                 "(every process must see a full slice)")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"[0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.partition = partition
        self.shuffle = shuffle
        self.emg_train_length = emg_train_length
        self.hopsize = hopsize
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch = -1

    @property
    def local_batch_size(self) -> int:
        return self.batch_size // self.process_count

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> Iterator[np.ndarray]:
        """Global batch index chunks — identical in every process."""
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _host_slice(self, chunk: np.ndarray) -> np.ndarray:
        """This process's contiguous slice of a global batch."""
        local = self.local_batch_size if self.process_count > 1 else len(chunk)
        start = self.process_index * local
        return chunk[start:start + local]

    def _crop_starts(self, global_indices: np.ndarray,
                     unit_lengths) -> np.ndarray:
        """Per-item crop starts seeded by (seed, epoch, global index), so any
        partitioning of the global batch crops every utterance identically.
        ``unit_lengths`` are the items' speech-unit frame counts (so the
        index-only device-resident path draws identical starts without
        loading items)."""
        frames = self.emg_train_length // self.hopsize
        starts = np.empty(len(global_indices), np.int64)
        for row, (j, n) in enumerate(zip(global_indices, unit_lengths)):
            hi = 1 + max(0, int(n) - frames)
            starts[row] = np.random.default_rng(
                (self.seed, self._epoch, int(j))).integers(0, hi)
        return starts

    def skip_epochs(self, n: int) -> None:
        """Advance the seeded state past ``n`` epochs without loading data:
        the next epoch is then the one a run from epoch 0 sees as epoch
        ``n``."""
        for _ in range(n):
            self._epoch += 1
            if self.shuffle:  # the same draws as one epoch's shuffle
                self._rng.shuffle(np.arange(len(self.dataset)))

    def _epoch_chunks(self, skip: int) -> Iterator[np.ndarray]:
        """This process's index chunks of the next epoch, from batch
        ``skip`` on."""
        self._epoch += 1
        for i, chunk in enumerate(self._index_batches()):
            if i >= skip:
                yield self._host_slice(chunk)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_epoch()

    def iter_epoch(self, skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The next epoch's batches, from batch ``skip`` on (a resumed run
        continues mid-epoch)."""
        for local in self._epoch_chunks(skip):
            items = [self.dataset[int(j)] for j in local]
            starts = (self._crop_starts(
                local, [len(it[C.DataType.SPEECH_UNITS]) for it in items])
                if self.partition == "train" else None)
            yield ste_gan_collate(
                items, partition=self.partition,
                emg_train_length=self.emg_train_length,
                hopsize=self.hopsize, starts=starts)


class Prefetcher:
    """Background-thread prefetch of an iterator (the analogue of the
    reference's num_workers=2 async loading; ste_gan/constants.py:54).
    When the consumer stops early (``break``, ``return``, an exception), the
    worker stops too and is joined."""

    _SENTINEL = object()

    def __init__(self, make_iter: Callable[[], Iterator], depth: int = 2):
        self._make_iter = make_iter
        self._depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        error = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._make_iter():
                    if not put(item):
                        return
            except BaseException as exc:  # propagate into the consumer
                error.append(exc)
            finally:
                put(self._SENTINEL)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)


def to_device(batch: Dict[str, Optional[np.ndarray]], device: torch.device,
              float_dtype: Optional[np.dtype] = None
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``; ``None`` entries are dropped.
    f32 arrays are cast to ``float_dtype`` on the host first (the train
    path's f16 wire format). To the card the arrays go through pinned
    memory with ``non_blocking=True``, so the copy overlaps the work
    already queued."""
    out = {}
    for key, value in batch.items():
        if value is None:
            continue
        if float_dtype is not None and value.dtype == np.float32:
            value = value.astype(float_dtype)
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out


def loaders(
    data_root: Path,
    strict: bool = False,
    hopsize: int = C.HOPSIZE,
    train_emg_length: int = C.TRAIN_EMG_LENGTH,
    batch_size: int = C.BATCH_SIZE,
    seed: int = 0,
    drop_last_train: bool = True,
    process_index: int = 0,
    process_count: int = 1,
):
    """Build (train, valid, test) loaders with the reference's dataset
    filters and train-derived vocabularies (ste_gan/data/loader.py:19-90).

    ``drop_last_train=True`` keeps every train step at the full batch
    shape. ``process_index``/``process_count`` shard the TRAIN loader's
    global batches across processes (valid/test stay whole)."""
    train_ds = EMGDataset(data_root, partition="train", strict=strict,
                          filter_by_length=True, only_include_voiced=True,
                          train_emg_length=train_emg_length)
    valid_ds = EMGDataset(data_root, partition="valid",
                          session_id_to_idx=train_ds.session_id_to_idx,
                          speaking_mode_id_to_idx=train_ds.speaking_mode_id_to_idx,
                          only_include_voiced=True, filter_by_length=True,
                          train_emg_length=train_emg_length, strict=strict)
    test_ds = EMGDataset(data_root, partition="test",
                         session_id_to_idx=train_ds.session_id_to_idx,
                         speaking_mode_id_to_idx=train_ds.speaking_mode_id_to_idx,
                         only_include_voiced=True, filter_by_length=False,
                         train_emg_length=train_emg_length, strict=strict)
    EMGDataset.check_no_data_overlap([train_ds, valid_ds, test_ds])
    if len(train_ds) < batch_size:
        # Fail fast: with an empty/undersized train partition the trainer
        # would spin through zero-batch epochs forever (drop_last).
        raise ValueError(
            f"train partition at {data_root} has {len(train_ds)} usable "
            f"utterances (< batch_size {batch_size}). If this is the "
            "synthetic development corpus, (re)generate it with: "
            "python -m ste_gan_torch.data.synthetic --root data/synthetic")

    train_loader = DataLoader(train_ds, batch_size, "train", shuffle=True,
                              emg_train_length=train_emg_length,
                              hopsize=hopsize, seed=seed,
                              drop_last=drop_last_train,
                              process_index=process_index,
                              process_count=process_count)
    valid_loader = DataLoader(valid_ds, batch_size, "valid", shuffle=False,
                              emg_train_length=train_emg_length, hopsize=hopsize)
    test_loader = DataLoader(test_ds, 1, "test", shuffle=False,
                             emg_train_length=train_emg_length, hopsize=hopsize)
    return train_loader, valid_loader, test_loader


def loaders_via_config(cfg):
    return loaders(
        data_root=Path(cfg.data.dataset_root),
        strict=cfg.data.strict,
        hopsize=C.HOPSIZE,
        train_emg_length=cfg.train.chunk_size,
        batch_size=cfg.train.batch_size,
        seed=cfg.train.random_seed,
    )
