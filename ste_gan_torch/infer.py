"""Inference: speech features -> 800 Hz EMG, and 800 Hz EMG -> 50 Hz units
and phonemes.

Counterpart of ``ste_gan_tpu/infer.py``:

* :class:`EMGSynthesizer`: batched, bucketed, padded and streaming synthesis
  through the generator's valid-length masks
  (``models/generator.py``), which make right padding and chunk windows
  equal to the conv stack's boundary zero padding;
* :func:`convert_dataset`: a dataset split converted in length-sorted,
  bucketed, stacked batches with per-row session, speaking mode and valid
  length, one batch in flight ahead of the host (pinned copies on a card);
* :class:`EMGDecoder`: the encoder as a decoder, full-length and in
  fixed-length streaming windows of true samples.

Everything runs under ``torch.inference_mode()`` on ``cuda`` unless the
caller passes ``device="cpu"``; without a card the constructors raise. On
one card the generator's forward replays from a CUDA graph per call shape
(``infer_graphs.py``): each shape's first call runs eagerly, its second
captures, later ones replay. The JAX package's bucketing keeps its compile
cache small; here it keeps the semantics (pad, mask, trim) and the number
of distinct shapes cuDNN and the graphs see.
On the card "exact" means equal to f32 reduction noise: cuDNN may pick
another algorithm for another length, and f32 convs run in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off.

Scale-out (the JAX package's ``mesh=``): ``EMGSynthesizer(...,
devices=[...])`` holds one replica of the generator per device, pads a
batch to a multiple of the device count with masked ``valid=0`` rows,
splits the rows, launches the replicas in turn (CUDA launches return at
once, so the cards work side by side) and merges and trims the outputs.
"""
from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import (Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from ste_gan_torch import constants as C
from ste_gan_torch.device import resolve_device
from ste_gan_torch.infer_graphs import EAGER, GraphedForward
from ste_gan_torch.models.emg_encoder import init_emg_encoder
from ste_gan_torch.models.generator import (EMGGeneratorGanTTS,
                                            init_emg_generator)
from ste_gan_torch.utils.profiling import add, span

#: Per-side receptive field of the generator stack in input frames, the
#: streaming context (the JAX package's value).
GENERATOR_RECEPTIVE_FIELD_FRAMES = 128


def round_up(n: int, multiple: int) -> int:
    """The least multiple of ``multiple`` that is at least ``n``."""
    return -(-n // multiple) * multiple


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EMGSynthesizer:
    """Speech features -> EMG through ``generator`` (which holds its
    weights) on ``device``.

    Args:
        generator: the generator module; moved to ``device``, eval mode.
        bucket: frame-axis bucket (1: every length as it is).
        device: ``cuda`` unless given.
        devices: scale-out: one replica of the generator on each (a device
            may be named twice); the first is ``device``, where inputs and
            outputs live.
    """

    def __init__(self, generator: EMGGeneratorGanTTS, bucket: int = 1,
                 device=None, devices: Optional[Sequence] = None):
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else [resolve_device(device)])
        self.device = self.devices[0]
        self.generator = generator.to(self.device).eval().requires_grad_(False)
        self.replicas = [self.generator] + [
            copy.deepcopy(self.generator).to(d) for d in self.devices[1:]]
        self._graphed = GraphedForward(self.generator)
        self.bucket = max(1, int(bucket))
        self.upsample = generator.upsample_factor

    @classmethod
    def from_config(cls, cfg, state_dict, bucket: int = 1,
                    dtype=torch.float32, device=None,
                    devices: Optional[Sequence] = None) -> "EMGSynthesizer":
        """A generator of ``cfg`` computing in ``dtype`` (f32 unless asked
        otherwise, as the JAX package's) with the weights of
        ``state_dict`` (reference layout)."""
        # A generator of its own keeps the global RNG untouched; the
        # weights are replaced below.
        synth = cls(init_emg_generator(cfg, dtype,
                                       torch.Generator().manual_seed(0)),
                    bucket, device, devices)
        synth.set_params(state_dict)
        return synth

    def set_params(self, state_dict) -> None:
        """Copy ``state_dict`` into every replica's own tensors, in place
        (strict: the keys and shapes must match)."""
        for replica in self.replicas:
            replica.load_state_dict(state_dict, strict=True)

    # ------------------------------------------------------------------
    # A tensor in page-locked host memory (``convert_dataset``'s staging)
    # is copied without a wait; anything else, numpy above all (the
    # service's batches), as before, with the copy's wait for the card.
    def _index(self, values, rows: int) -> torch.Tensor:
        if values is None:
            return torch.zeros((rows,), dtype=torch.long, device=self.device)
        if isinstance(values, torch.Tensor):
            return values.to(self.device, torch.long,
                             non_blocking=values.is_pinned())
        return torch.as_tensor(values, device=self.device).long()

    def _lengths(self, rows: int, length: int) -> torch.Tensor:
        """``[rows]`` of ``length`` on the device, filled there: no copy
        from the host, which a graph capture cannot hold."""
        return torch.full((rows,), length, dtype=torch.long,
                          device=self.device)

    def _features(self, feats) -> torch.Tensor:
        if isinstance(feats, torch.Tensor):
            return feats.to(self.device, torch.float32,
                            non_blocking=feats.is_pinned())
        return torch.from_numpy(np.asarray(feats, np.float32)).to(
            self.device)

    @torch.inference_mode()
    def _forward(self, feats, session_idx, mode_idx, num_valid):
        """The generator on a batch on ``self.device``; ``num_valid`` is
        None or ``[B]`` on the device. One replica: through the graphs."""
        if len(self.replicas) == 1:
            return self._graphed(feats, session_idx, mode_idx, num_valid)
        add(EAGER, 1)
        # Pad the rows to a multiple of the replicas with masked rows
        # (valid 0), give each replica its share, merge and trim.
        rows, n = feats.shape[0], len(self.replicas)
        pad = (-rows) % n
        if pad:
            if num_valid is None:
                num_valid = self._lengths(rows, feats.shape[1])
            num_valid = F.pad(num_valid, (0, pad))
            feats = F.pad(feats, (0, 0, 0, 0, 0, pad))
            session_idx = F.pad(session_idx, (0, pad))
            mode_idx = F.pad(mode_idx, (0, pad))
        share = (rows + pad) // n
        outs = []
        for i, (replica, dev) in enumerate(zip(self.replicas, self.devices)):
            part = slice(i * share, (i + 1) * share)
            outs.append(replica(
                feats[part].to(dev), session_idx[part].to(dev),
                mode_idx[part].to(dev),
                num_valid_frames=(None if num_valid is None
                                  else num_valid[part].to(dev))))
        return torch.cat([o.to(self.device) for o in outs])[:rows]

    def synthesize_batch(self, feats, session_idx,
                         mode_idx=None) -> torch.Tensor:
        """``[B, T, D]`` features -> ``[B, upsample*T, C]`` EMG on the
        device. Pads T up to the bucket and trims the output back; the
        padded frames are masked."""
        feats = self._features(feats)
        b, t, _ = feats.shape
        padded_t = round_up(t, self.bucket)
        valid = None
        if padded_t != t:
            feats = F.pad(feats, (0, 0, 0, padded_t - t))
            valid = self._lengths(b, t)
        emg = self._forward(feats, self._index(session_idx, b),
                            self._index(mode_idx, b), valid)
        return emg[:, : self.upsample * t]

    def synthesize_padded(self, feats, session_idx, mode_idx,
                          num_valid) -> torch.Tensor:
        """A batch with per-row valid lengths: ``[B, Tpad, D]`` + valid
        ``[B]`` -> ``[B, upsample*Tpad, C]``; row ``b`` is exact up to
        ``upsample*valid[b]`` (its padded frames are masked). The copies
        to the device run in the ``synth/h2d`` span, the generator's
        launches in ``synth/forward``. A copy from a tensor in page-locked
        host memory does not wait; from numpy it waits for the card, so
        the caller may reuse its arrays at once."""
        with span("synth/h2d"):
            feats = self._features(feats)
            b = feats.shape[0]
            index = (self._index(session_idx, b), self._index(mode_idx, b),
                     self._index(num_valid, b))
        with span("synth/forward"):
            return self._forward(feats, *index)

    def synthesize(self, feats: np.ndarray, session_idx: int,
                   mode_idx: int = 0) -> np.ndarray:
        """One utterance ``[T, D]`` -> ``[upsample*T, C]`` (numpy f32)."""
        out = self.synthesize_batch(np.asarray(feats)[None], [session_idx],
                                    [mode_idx])
        return out[0].float().cpu().numpy()

    # ------------------------------------------------------------------
    def synthesize_streaming(
            self, feats: np.ndarray, session_idx: int,
            chunk_frames: int = 128, mode_idx: int = 0,
            context_frames: int = GENERATOR_RECEPTIVE_FIELD_FRAMES,
    ) -> Iterable[np.ndarray]:
        """Yields EMG chunks of ``upsample*chunk_frames`` samples. Each
        chunk is generated with ``context_frames`` of feature context on
        both sides in a window padded to ``chunk + 2*context`` frames and
        masked, so chunk interiors equal the full-utterance result."""
        t = len(feats)
        up = self.upsample
        target = chunk_frames + 2 * context_frames
        for start in range(0, t, chunk_frames):
            stop = min(start + chunk_frames, t)
            lo = max(0, start - context_frames)
            hi = min(t, stop + context_frames)
            window = np.zeros((1, target, feats.shape[1]), np.float32)
            window[0, : hi - lo] = feats[lo:hi]
            emg = self._forward(self._features(window),
                                self._index([session_idx], 1),
                                self._index([mode_idx], 1),
                                self._index([hi - lo], 1))[0]
            yield emg[(start - lo) * up:(stop - lo) * up].float().cpu().numpy()

    # ------------------------------------------------------------------
    def real_time_factor(self, num_frames: int = 500, iters: int = 20,
                         batch: int = 1) -> float:
        """Synthesis wall time over the duration of the EMG it makes (lower
        is better). Features are 50 Hz for the x16 generator and 100 Hz for
        the x8 one. Two untimed calls first: on one card the first runs
        eagerly and the second captures the shape's CUDA graph, so the
        timed calls replay it (factors from before the graphs timed eager
        launches); on a card the timed loop ends in
        ``torch.cuda.synchronize()``."""
        feats_rate = 50.0 if self.upsample == 16 else 100.0
        dim = self.generator.speech_input_dim
        feats = torch.zeros((batch, num_frames, dim), device=self.device)
        sess = torch.zeros((batch,), dtype=torch.long, device=self.device)
        for _ in range(2):
            self.synthesize_batch(feats, sess)
        _synchronize(self.device)
        start = time.perf_counter()
        for _ in range(iters):
            self.synthesize_batch(feats, sess)
        _synchronize(self.device)
        elapsed = (time.perf_counter() - start) / iters
        return elapsed / (num_frames / feats_rate * batch)


#: Counters of :func:`convert_dataset`'s pipeline, one per batch after the
#: first of a pass on a card: the batch before was still unfinished when
#: this one was queued (the card had work queued while the host packed), or
#: it had finished (the card may have waited for the host).
AHEAD = "synth/ahead"
BEHIND = "synth/behind"


class _Queued(NamedTuple):
    """A batch of :func:`convert_dataset` queued and not yet fetched."""

    chunk: List[int]
    lengths: List[int]
    padded: int
    #: The batch's EMG in host memory once ``done``.
    out: torch.Tensor
    #: On a card, recorded after the copy back; None on the CPU.
    done: Optional[torch.cuda.Event]


def convert_dataset(synth: EMGSynthesizer, dataset,
                    feature_key: str = C.DataType.SPEECH_UNITS,
                    bucket: int = 64, max_batch: int = 16) -> List[Dict]:
    """Batched multi-session synthesis of a whole split.

    Utterances are sorted by length and grouped by their bucketed frame
    length; each group runs in stacked batches of at most ``max_batch``
    rows with per-row session, speaking mode and valid length (the padded
    frames are masked). Returns, in dataset order, ``{utt_id, fake_emg
    [upsample*T, C] numpy, session_id}``; each ``fake_emg`` owns its
    memory.

    One batch is in flight ahead of the host: batch n+1 is packed and
    queued before batch n is fetched, so on a card the host's work
    overlaps the card's. There a batch is packed straight into page-locked
    host tensors (PyTorch's caching host allocator, which reuses a block
    only after the copies recorded on it have completed), copied to the
    card and back without a wait, and fetched through an event; each
    result is copied out of the pinned block. On the CPU the same loop
    runs in pageable memory, one step after the other.

    Per batch, the spans ``synth/pack``, ``synth/h2d``, ``synth/forward``,
    ``synth/fetch`` (the wait for the batch's copy back, the wait for the
    device) and ``synth/unpack``, and the counters ``synth/batches``,
    ``synth/valid_frames`` and ``synth/computed_frames`` (rows times the
    padded length) of ``utils/profiling.py``; on a card :data:`AHEAD` or
    :data:`BEHIND` for each batch after the first."""
    up = synth.upsample
    pinned = synth.device.type == "cuda"
    items = [dataset[i] for i in range(len(dataset))]
    order = sorted(range(len(items)),
                   key=lambda i: len(items[i][feature_key]))
    results: List[Optional[Dict]] = [None] * len(items)

    groups: Dict[int, List[int]] = {}
    for i in order:
        padded = round_up(max(1, len(items[i][feature_key])), bucket)
        groups.setdefault(padded, []).append(i)

    def launch(chunk: List[int], padded: int,
               previous: Optional[_Queued]) -> _Queued:
        with span("synth/pack"):
            rows = len(chunk)
            dim = items[chunk[0]][feature_key].shape[-1]
            feats = torch.empty((rows, padded, dim), dtype=torch.float32,
                                pin_memory=pinned)
            # Rows: session, speaking mode, valid length.
            index = torch.empty((3, rows), dtype=torch.long,
                                pin_memory=pinned)
            host, codes = feats.numpy(), index.numpy()
            lengths = [len(items[i][feature_key]) for i in chunk]
            for row, i in enumerate(chunk):
                host[row, : lengths[row]] = items[i][feature_key]
                host[row, lengths[row]:] = 0
                codes[:, row] = (
                    int(items[i][C.DataType.SESSION_INDEX]),
                    int(items[i][C.DataType.SPEAKING_MODE_INDEX]),
                    lengths[row])
        if previous is not None and previous.done is not None:
            add(BEHIND if previous.done.query() else AHEAD, 1)
        emg = synth.synthesize_padded(feats, *index)
        out = torch.empty(emg.shape, dtype=torch.float32, pin_memory=pinned)
        out.copy_(emg.float(), non_blocking=pinned)
        done = None
        if pinned:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(emg.device))
        return _Queued(chunk, lengths, padded, out, done)

    def finish(batch: _Queued) -> None:
        with span("synth/fetch"):
            if batch.done is not None:
                batch.done.synchronize()
            emg = batch.out.numpy()
        with span("synth/unpack"):
            for row, i in enumerate(batch.chunk):
                results[i] = {
                    C.DataType.UTT_ID: items[i][C.DataType.UTT_ID],
                    C.DataType.FAKE_EMG:
                        emg[row, : up * batch.lengths[row]].copy(),
                    C.DataType.SESSION_ID: items[i][C.DataType.SESSION_ID],
                }
        add("synth/batches", 1)
        add("synth/valid_frames", sum(batch.lengths))
        add("synth/computed_frames", len(batch.chunk) * batch.padded)

    pending = None
    for padded, indices in groups.items():
        for start in range(0, len(indices), max_batch):
            queued = launch(indices[start:start + max_batch], padded,
                            pending)
            if pending is not None:
                finish(pending)
            pending = queued
    if pending is not None:
        finish(pending)
    return results


# ---------------------------------------------------------------------------
# The decode direction: 800 Hz EMG -> 50 Hz (speech units, phonemes)
# ---------------------------------------------------------------------------


def decoder_receptive_field_frames(model) -> int:
    """Per-side receptive field of the EMG encoder in 50 Hz frames: each of
    the L transformer layers, whose attention is hard-windowed at
    ``relative_positional_distance``, widens a frame's dependency cone by
    at most ``distance - 1`` frames; the strided conv front end adds under
    one frame, budgeted as 2."""
    layers = model.transformer.layers
    if len(layers) == 0:
        return 2
    distance = layers[0].self_attn.relative_positional.max_distance
    return len(layers) * (distance - 1) + 2


class EMGDecoder:
    """EMG -> (speech units, phoneme logits) through the encoder in eval
    mode (running statistics, no dropout) on ``device``.

    :meth:`decode` runs one full-length utterance; :meth:`decode_streaming`
    yields chunks computed in fixed-length windows of true samples
    (shifted inward at the edges, never zero padded: the encoder has no
    valid-length mask), which equal the full decode when the context
    covers :func:`decoder_receptive_field_frames`.
    """

    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_path, device=None) -> "EMGDecoder":
        """Load the reference-layout state dict that the port's encoder
        trainer writes (``<enc_run>/best_val_loss_model.pt``), strictly,
        into an f32 encoder of ``cfg``."""
        dev = resolve_device(device)
        model = init_emg_encoder(cfg, torch.float32)
        model.load_state_dict(torch.load(Path(ckpt_path), map_location="cpu",
                                         weights_only=True), strict=True)
        return cls(model, dev)

    @torch.inference_mode()
    def _forward(self, emg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = torch.from_numpy(np.asarray(emg, np.float32)[None]).to(self.device)
        units, ph = self.model(x)
        return units[0].cpu().numpy(), ph[0].cpu().numpy()

    def decode(self, emg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``[T, C]`` EMG (T a multiple of 16) -> (``[F, 256]`` units,
        ``[F, 48]`` phoneme logits), F = T // 16. No padding."""
        if emg.shape[0] % C.HOPSIZE:
            raise ValueError(
                f"EMG length {emg.shape[0]} must be a multiple of "
                f"{C.HOPSIZE} (one 50 Hz frame of 800 Hz samples)")
        return self._forward(emg)

    def decode_streaming(self, emg: np.ndarray, chunk_frames: int = 100,
                         context_frames: Optional[int] = None):
        """Yields ``([chunk, 256], [chunk, 48])`` pairs covering the
        utterance in order; concatenated they equal :meth:`decode` to float
        reduction noise when ``context_frames`` (default:
        :func:`decoder_receptive_field_frames`) covers the dependency
        cone. A window nominally ``[start - ctx, stop + ctx)`` is shifted
        inward at the signal's edges, keeping its length; utterances
        shorter than one window take one full decode."""
        hop = C.HOPSIZE
        if emg.shape[0] % hop:
            raise ValueError(
                f"EMG length {emg.shape[0]} must be a multiple of {hop}")
        total = emg.shape[0] // hop
        ctx = (decoder_receptive_field_frames(self.model)
               if context_frames is None else context_frames)
        target = chunk_frames + 2 * ctx
        if total <= target:
            units, ph = self.decode(emg)
            for start in range(0, total, chunk_frames):
                stop = min(start + chunk_frames, total)
                yield units[start:stop], ph[start:stop]
            return
        for start in range(0, total, chunk_frames):
            stop = min(start + chunk_frames, total)
            lo = min(max(0, start - ctx), total - target)
            units, ph = self._forward(emg[lo * hop:(lo + target) * hop])
            yield units[start - lo:stop - lo], ph[start - lo:stop - lo]
