"""Speech -> EMG synthesis serving: dynamic micro-batching and an HTTP front
end.

Counterpart of ``ste_gan_tpu/serve.py``:

* :class:`MicroBatcher`: a bounded request queue whose worker thread blocks
  on the first request, drains whatever else arrives within
  ``max_wait_ms`` (up to ``max_batch``), pads the batch to the bucketed
  length of its longest row, runs ONE ``synthesize_padded`` with per-row
  valid lengths (exact: the generator masks the padding) and trims each
  row. An error reaches every waiter of its batch.
* :class:`SynthesisService`: a run directory's EMA weights or a serving
  artifact, its session vocabulary, warm-up, stats and hot reload.
* :class:`EMGDecoderService`: EMG -> (units, phoneme logits) from an encoder
  artifact or checkpoint, zero-padded to the bucket above ``min_frames``,
  at most ``max_concurrent`` at a time (503 beyond).
* :func:`main`: ``python -m ste_gan_torch.serve --run_dir <gan_run>`` (or
  ``--artifact``), a stdlib ThreadingHTTPServer speaking npz/npy bytes:

      POST /synthesize         npz {feats [T, D] f32, session, mode} -> npy
                               [upsample*T, C] (503 + Retry-After when the
                               bounded queue is full)
      POST /synthesize_stream  the same request; the EMG as frames of an
                               8-byte big-endian byte count + raw f32
                               [n, C], ended by a zero count (501 from an
                               artifact)
      POST /decode             npz {emg [T, C] f32} -> npz {units,
                               phoneme_logits}
      POST /reload             JSON {run_dir?, tag?, artifact?}: new weights
                               without downtime
      GET  /healthz, /stats    liveness; counters, p50/p95/p99 latency, batch
                               occupancy, queue depth, rejections, reloads

**Reload.** JAX swaps an immutable parameter tree. Here a reload checks the
new state dict's keys and shapes first, loads it into a *new* synthesizer
and swaps the reference that the worker reads once per batch, so a batch
runs wholly on the old weights or wholly on the new, and a bad checkpoint
changes no served weight (``EMGSynthesizer.set_params`` copies in place and
raises only after copying every key whose shape matched).

Runs on ``cuda`` unless the caller passes ``device="cpu"``/``--device cpu``.
``--data_parallel N`` serves over the first N cards (checkpoint mode only,
as in JAX): each coalesced batch's rows split over N replicas
(``EMGSynthesizer(devices=...)``); fewer cards than N raises. On the CPU
it runs N replicas there. Not ported: ``HostMemoryWatchdog`` and the exec
restart (``--host_rss_restart_gb``), which work around a remote-TPU
transport.
"""
from __future__ import annotations

import argparse
import copy
import io
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.device import resolve_device
from ste_gan_torch.infer import EMGSynthesizer, round_up


class LatencyWindow:
    """Thread-safe window of recent latencies and its percentiles (shared
    by the micro-batcher and the decoder service)."""

    def __init__(self, maxlen: int = 4096):
        self._lat = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        with self._lock:
            self._lat.append(ms)

    def extend(self, ms_values) -> None:
        with self._lock:
            self._lat.extend(ms_values)

    def clear(self) -> None:
        with self._lock:
            self._lat.clear()

    def percentiles(self) -> Dict:
        with self._lock:
            lats = np.asarray(self._lat, np.float64)
        if not len(lats):
            return {}
        p50, p95, p99 = np.percentile(lats, [50, 95, 99])
        return {"latency_ms_p50": float(p50), "latency_ms_p95": float(p95),
                "latency_ms_p99": float(p99)}


class ServiceOverloadedError(RuntimeError):
    """Raised when the bounded request queue (or the decoder's concurrency
    limit) is full; the HTTP front end answers 503 + Retry-After."""


@dataclass
class _Request:
    feats: np.ndarray           # [T, D] float32
    session_idx: int
    mode_idx: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    enqueued_at: float = field(default_factory=time.perf_counter)


class MicroBatcher:
    """Coalesce concurrent synthesis requests into single device calls.

    ``synthesizer`` needs ``synthesize_padded`` and ``upsample``
    (``EMGSynthesizer`` or ``ExportedSynthesizer``). The worker reads
    ``self._synth`` once per batch, so replacing it swaps the model between
    batches."""

    def __init__(self, synthesizer, max_batch: int = 8,
                 max_wait_ms: float = 5.0, bucket: int = 64,
                 max_queue: int = 64):
        self._synth = synthesizer
        self.max_batch = max(1, max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.bucket = max(1, bucket)
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(1, max_queue))
        self._stop = threading.Event()
        self.stats = {
            "requests": 0, "batches": 0, "batched_requests": 0,
            "max_batch_seen": 0, "latency_ms_sum": 0.0, "rejected": 0,
        }
        self._lat_ms = LatencyWindow()
        self._batch_sizes = deque(maxlen=4096)
        self._stats_lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, feats: np.ndarray, session_idx: int,
               mode_idx: int = 0, timeout: float = 900.0) -> np.ndarray:
        """Blocking call from any thread; returns ``[upsample*T, C]`` EMG.
        Raises :class:`ServiceOverloadedError` when the queue is full."""
        req = _Request(np.asarray(feats, np.float32), int(session_idx),
                       int(mode_idx))
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.stats["rejected"] += 1
            raise ServiceOverloadedError(
                f"request queue full ({self._queue.maxsize} pending); "
                "retry later") from None
        if not req.done.wait(timeout):
            raise TimeoutError("synthesis request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------
    def _drain(self) -> List[_Request]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run_batch(self, synth, batch: List[_Request]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """One padded call: ``(emg [B, upsample*Tpad, C], valid [B])``."""
        t_pad = round_up(max(len(r.feats) for r in batch), self.bucket)
        dim = batch[0].feats.shape[-1]
        feats = np.zeros((len(batch), t_pad, dim), np.float32)
        valid = np.zeros((len(batch),), np.int64)
        sess = np.zeros((len(batch),), np.int64)
        mode = np.zeros((len(batch),), np.int64)
        for row, r in enumerate(batch):
            feats[row, : len(r.feats)] = r.feats
            valid[row] = len(r.feats)
            sess[row] = r.session_idx
            mode[row] = r.mode_idx
        emg = synth.synthesize_padded(feats, sess, mode, valid)
        return emg.float().cpu().numpy(), valid

    def _worker(self) -> None:
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            synth = self._synth  # once per batch: a reload swaps between
            try:
                emg, valid = self._run_batch(synth, batch)
            except Exception as exc:  # every waiter sees the failure
                for r in batch:
                    r.error = exc
                    r.done.set()
                continue
            now = time.perf_counter()
            lats = [(now - r.enqueued_at) * 1e3 for r in batch]
            with self._stats_lock:
                s = self.stats
                s["requests"] += len(batch)
                s["batches"] += 1
                s["batched_requests"] += len(batch) if len(batch) > 1 else 0
                s["max_batch_seen"] = max(s["max_batch_seen"], len(batch))
                s["latency_ms_sum"] += sum(lats)
                self._batch_sizes.append(len(batch))
            self._lat_ms.extend(lats)
            # After the stats, so a caller that returns sees its batch
            # counted.
            for row, r in enumerate(batch):
                r.result = emg[row, : synth.upsample * valid[row]]
                r.done.set()

    def reset_windows(self) -> None:
        """Empty the latency and batch-size windows (the percentiles and
        occupancy of :meth:`stats_snapshot`), e.g. after a warm-up; the
        counters run on."""
        with self._stats_lock:
            self._batch_sizes.clear()
        self._lat_ms.clear()

    def stats_snapshot(self) -> Dict:
        with self._stats_lock:
            s = dict(self.stats)
            sizes = np.asarray(self._batch_sizes, np.float64)
        s["mean_latency_ms"] = (s["latency_ms_sum"] / s["requests"]
                                if s["requests"] else 0.0)
        s.update(self._lat_ms.percentiles())
        if len(sizes):
            s.update(batch_occupancy_mean=float(sizes.mean()),
                     batch_occupancy_max=int(sizes.max()))
        s["queue_depth"] = self._queue.qsize()
        return s


def _load_vocab(path: Path) -> Optional[Dict[str, int]]:
    if path.exists():
        idx_to_id = json.loads(path.read_text())
        return {v: int(k) for k, v in idx_to_id.items()}
    return None


def load_served_generator(run_dir: Path, tag: str, device):
    """``(cfg, compute dtype, state dict)`` of a GAN run's checkpoint
    ``tag``: the EMA weights when EMA training is on, as synthesis and
    evaluation use them."""
    from ste_gan_torch.train.gan import (eval_generator_state_dict,
                                         load_trained_state)

    cfg, models, state = load_trained_state(run_dir, tag, device=device)
    return cfg, models.generator.dtype, eval_generator_state_dict(models,
                                                                  state)


def serving_devices(data_parallel: int, device) -> Optional[List]:
    """The devices of ``--data_parallel N`` on ``device``'s kind: cards
    0..N-1 (ValueError when fewer are present), or N times the CPU; None
    for one device."""
    if data_parallel <= 1:
        return None
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * data_parallel
    cards = torch.cuda.device_count()
    if cards < data_parallel:
        raise ValueError(f"--data_parallel {data_parallel}: only {cards} "
                         f"card(s) present")
    return [torch.device("cuda", i) for i in range(data_parallel)]


class SynthesisService:
    """A served synthesizer, its session vocabulary and its micro-batcher."""

    def __init__(self, synthesizer, session_id_to_idx: Dict[str, int],
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 bucket: int = 64, max_queue: int = 64):
        self.session_id_to_idx = dict(session_id_to_idx)
        self.batcher = MicroBatcher(synthesizer, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms, bucket=bucket,
                                    max_queue=max_queue)
        # Where the weights came from and how often they were swapped,
        # changed under one lock.
        self._source: Dict = {}
        self._reload_lock = threading.Lock()
        self.reload_count = 0

    @property
    def synthesizer(self):
        """The synthesizer that the next batch runs."""
        return self.batcher._synth

    @classmethod
    def from_artifact(cls, artifact: Path, max_batch: int = 8,
                      max_wait_ms: float = 5.0, bucket: int = 64,
                      max_queue: int = 64, device=None) -> "SynthesisService":
        """Serve a serving artifact (``python -m
        ste_gan_torch.export_generator --serving``): no checkpoint, module
        or config; the session vocabulary JSON is read from the artifact's
        directory when present. The streaming endpoint answers 501."""
        from ste_gan_torch.export import ExportedSynthesizer

        artifact = Path(artifact)
        synth = ExportedSynthesizer(artifact, device=device)
        service = cls(synth, _load_vocab(
            artifact.parent / "session_idx_to_id.json") or {},
            max_batch=max_batch, max_wait_ms=max_wait_ms, bucket=bucket,
            max_queue=max_queue)
        service._source = {"mode": "artifact", "artifact": str(artifact)}
        return service

    @classmethod
    def from_run_dir(cls, run_dir: Path, tag: str = "best",
                     max_batch: int = 8, max_wait_ms: float = 5.0,
                     bucket: int = 64, max_queue: int = 64,
                     data_parallel: int = 0, device=None,
                     dtype=None) -> "SynthesisService":
        """The EMA weights of checkpoint ``tag`` of a port GAN run (the
        layout ``generate_emg`` reads), computing in ``dtype`` (the trained
        compute dtype when None); over ``data_parallel`` devices when above
        1 (:func:`serving_devices`)."""
        devices = serving_devices(data_parallel, device)
        dev = devices[0] if devices else resolve_device(device)
        run_dir = Path(run_dir)
        cfg, trained, state_dict = load_served_generator(run_dir, tag, dev)
        synth = EMGSynthesizer.from_config(
            cfg, state_dict, dtype=trained if dtype is None else dtype,
            device=dev, devices=devices)
        service = cls(synth, _load_vocab(
            run_dir / "session_idx_to_id.json") or {},
            max_batch=max_batch, max_wait_ms=max_wait_ms, bucket=bucket,
            max_queue=max_queue)
        service._source = {"mode": "run_dir", "run_dir": str(run_dir),
                           "tag": tag}
        return service

    # ------------------------------------------------------------------
    def _with_weights(self, state_dict) -> EMGSynthesizer:
        """A new synthesizer like the served one holding ``state_dict``;
        raises, touching nothing served, when its keys or shapes differ."""
        current = self.synthesizer
        served = current.generator.state_dict()
        if set(state_dict) != set(served):
            raise ValueError(
                "checkpoint state-dict structure does not match the served "
                "model: not swapping")
        mism = [k for k, v in served.items()
                if tuple(state_dict[k].shape) != tuple(v.shape)]
        if mism:
            raise ValueError(f"checkpoint tensor shapes differ from the "
                             f"served model at {mism[:3]}: not swapping")
        generator = copy.deepcopy(current.generator)
        generator.load_state_dict(state_dict, strict=True)
        return EMGSynthesizer(generator, bucket=current.bucket,
                              devices=current.devices)

    def reload(self, run_dir=None, tag=None, artifact=None) -> Dict:
        """Swap the served weights without downtime.

        Checkpoint mode re-reads checkpoint ``tag`` of ``run_dir`` (default:
        the current source), checks its keys and shapes against the served
        model, loads it into a new synthesizer and swaps it in. Artifact
        mode (or passing ``artifact``) loads the new artifact and warms it
        on the service's bucket before the swap. In-flight batches finish on
        the old weights."""
        with self._reload_lock:
            if artifact is not None or self._source.get("mode") == "artifact":
                from ste_gan_torch.export import ExportedSynthesizer

                artifact = Path(artifact if artifact is not None
                                else self._source["artifact"])
                new = ExportedSynthesizer(artifact,
                                          device=self.synthesizer.device)
                b = self.batcher.bucket
                new.synthesize_padded(
                    np.zeros((1, b, new.generator.speech_input_dim),
                             np.float32), [0], [0], [b])
                vocab = _load_vocab(artifact.parent / "session_idx_to_id.json")
                source = {"mode": "artifact", "artifact": str(artifact)}
            else:
                run_dir = Path(run_dir if run_dir is not None
                               else self._source["run_dir"])
                tag = tag if tag is not None else self._source.get("tag",
                                                                   "best")
                _, _, state_dict = load_served_generator(
                    run_dir, tag, self.synthesizer.device)
                new = self._with_weights(state_dict)
                vocab = _load_vocab(run_dir / "session_idx_to_id.json")
                source = {"mode": "run_dir", "run_dir": str(run_dir),
                          "tag": tag}
            self.batcher._synth = new
            if vocab is not None:
                self.session_id_to_idx = vocab
            self._source = source
            self.reload_count += 1
            return {"reloaded": True, "reloads": self.reload_count,
                    **self._source}

    # ------------------------------------------------------------------
    def resolve_session(self, session) -> int:
        if isinstance(session, (int, np.integer)):
            return int(session)
        if session in self.session_id_to_idx:
            return self.session_id_to_idx[session]
        raise KeyError(f"unknown session id {session!r}; known: "
                       f"{sorted(self.session_id_to_idx)}")

    def _checked(self, feats, session, mode_idx):
        """``(feats [T, D] f32, session index, mode index)`` of a request,
        or ValueError before anything is queued: an index outside its
        embedding table would trip a device-side assert on the card, which
        fails every later call of the process, and a wrong feature shape
        would fail every request batched with it."""
        gen = self.synthesizer.generator
        feats = np.asarray(feats, np.float32)
        if (feats.ndim != 2 or len(feats) < 1
                or feats.shape[1] != gen.speech_input_dim):
            raise ValueError(f"feats must be [T >= 1, "
                             f"{gen.speech_input_dim}], got {feats.shape}")
        session, mode_idx = self.resolve_session(session), int(mode_idx)
        for name, idx, rows in (("session", session, gen.num_sessions),
                                ("speaking mode", mode_idx,
                                 gen.num_speaking_modes)):
            if rows is not None and not 0 <= idx < rows:
                raise ValueError(f"{name} index {idx} is outside the "
                                 f"model's [0, {rows})")
        return feats, session, mode_idx

    def synthesize(self, feats: np.ndarray, session, mode_idx: int = 0
                   ) -> np.ndarray:
        return self.batcher.submit(*self._checked(feats, session, mode_idx))

    def synthesize_stream(self, feats: np.ndarray, session,
                          mode_idx: int = 0, chunk_frames: int = 64):
        """EMG chunks as they are synthesised (receptive-field windows whose
        interiors equal the full utterance; ``EMGSynthesizer.
        synthesize_streaming``), bypassing the micro-batcher. Returns the
        synthesizer's chunk iterator itself, so that an artifact's
        ``NotImplementedError`` surfaces at the call, before the HTTP
        handler commits its headers."""
        feats, session, mode_idx = self._checked(feats, session, mode_idx)
        return self.synthesizer.synthesize_streaming(
            feats, session, chunk_frames=chunk_frames, mode_idx=mode_idx)

    def warmup(self, num_frames: int = 64, batch_sizes=(1,)) -> None:
        """One batch of each size through the batcher (cuDNN picks its
        algorithms for these shapes)."""
        dim = self.synthesizer.generator.speech_input_dim
        for b in batch_sizes:
            reqs = [threading.Thread(
                target=lambda: self.batcher.submit(
                    np.zeros((num_frames, dim), np.float32), 0))
                for _ in range(b)]
            for t in reqs:
                t.start()
            for t in reqs:
                t.join()

    def close(self) -> None:
        self.batcher.close()


class EMGDecoderService:
    """EMG -> (soft speech units, phoneme logits) from an encoder artifact
    (``python -m ste_gan_torch.export_emg_encoder``) or, with
    :meth:`from_checkpoint`, straight from the encoder trainer's ``.pt``:
    the silent-speech decoding direction, served beside synthesis.

    Lengths are zero-padded to a multiple of ``bucket`` 50 Hz frames, at
    least ``min_frames`` (the windowed relative-position regime). The
    encoder has no valid-length mask, so the padding perturbs valid frames
    within the attention window of its edge, as decoding a zero-padded
    recording would; ``bucket=1`` pads only to the 16-sample hop. For exact
    chunked decoding offline use ``infer.EMGDecoder``."""

    def __init__(self, artifact: Path, bucket: int = 64,
                 min_frames: Optional[int] = None, max_concurrent: int = 4,
                 device=None):
        from ste_gan_torch.export import load_exported, read_meta

        self.device = resolve_device(device)
        meta = read_meta(artifact)
        self._model = load_exported(artifact, self.device).module()
        if min_frames is None:
            min_frames = int(meta["min_frames"])
        self._init_common(int(meta["num_emg_channels"]), bucket, min_frames,
                          max_concurrent)

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_path: Path, bucket: int = 64,
                        min_frames: Optional[int] = None,
                        max_concurrent: int = 4,
                        device=None) -> "EMGDecoderService":
        """The encoder of ``cfg.emg_encoder`` with the weights of a
        reference-layout ``.pt`` (``<enc_run>/best_val_loss_model.pt``),
        without an export step."""
        from ste_gan_torch.export import encoder_min_frames
        from ste_gan_torch.infer import EMGDecoder

        decoder = EMGDecoder.from_checkpoint(cfg, ckpt_path, device=device)
        self = cls.__new__(cls)
        self.device = decoder.device
        self._model = decoder.model
        if min_frames is None:
            min_frames = encoder_min_frames(decoder.model)
        self._init_common(cfg.data.num_emg_channels, bucket, min_frames,
                          max_concurrent)
        return self

    def _init_common(self, channels: int, bucket: int, min_frames: int,
                     max_concurrent: int) -> None:
        self.channels = channels
        self.bucket = max(1, bucket)
        self.min_frames = min_frames
        # The /synthesize queue's backpressure for decodes: beyond
        # max_concurrent a request gets 503 instead of piling up.
        self._slots = threading.Semaphore(max(1, max_concurrent))
        self._lat_ms = LatencyWindow()
        self.stats = {"requests": 0, "rejected": 0}
        self._lock = threading.Lock()

    def decode(self, emg: np.ndarray):
        """``[T, C]`` f32 EMG -> (units ``[t, 256]``, phoneme logits ``[t,
        48]``) with ``t = T // 16`` (a trailing partial frame is dropped).
        Raises :class:`ServiceOverloadedError` beyond ``max_concurrent``."""
        emg = np.asarray(emg, np.float32)
        frames = len(emg) // C.HOPSIZE
        if frames < 1:
            raise ValueError(f"EMG too short: {len(emg)} samples "
                             f"(< {C.HOPSIZE})")
        if emg.shape[1] != self.channels:
            raise ValueError(f"expected {self.channels} EMG channels, "
                             f"got {emg.shape[1]}")
        pad = round_up(max(frames, self.min_frames), self.bucket)
        if not self._slots.acquire(blocking=False):
            with self._lock:
                self.stats["rejected"] += 1
            raise ServiceOverloadedError(
                "decoder at max concurrency; retry later")
        try:
            start = time.perf_counter()
            padded = np.zeros((1, pad * C.HOPSIZE, emg.shape[1]), np.float32)
            padded[0, : frames * C.HOPSIZE] = emg[: frames * C.HOPSIZE]
            with torch.no_grad():
                units, ph = self._model(torch.from_numpy(padded).to(
                    self.device))
            out = (units[0, :frames].cpu().numpy(),
                   ph[0, :frames].cpu().numpy())
        finally:
            self._slots.release()
        with self._lock:
            self.stats["requests"] += 1
        self._lat_ms.record((time.perf_counter() - start) * 1e3)
        return out

    def warmup(self) -> None:
        self.decode(np.zeros((self.min_frames * C.HOPSIZE, self.channels),
                             np.float32))

    def stats_snapshot(self) -> Dict:
        with self._lock:
            s = dict(self.stats)
        s.update(self._lat_ms.percentiles())
        return s


# ---------------------------------------------------------------------------
# HTTP front end (stdlib; npz in, npy out)
# ---------------------------------------------------------------------------


def make_http_server(service: SynthesisService, host: str = "127.0.0.1",
                     port: int = 8571,
                     decoder: Optional[EMGDecoderService] = None):
    """A ThreadingHTTPServer for ``service`` (and ``decoder``); ``port=0``
    takes a free port (``server.server_address[1]``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj, headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for name, value in headers:
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_bytes(self, data: bytes) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _read_npz(self):
            length = int(self.headers.get("Content-Length", 0))
            return np.load(io.BytesIO(self.rfile.read(length)),
                           allow_pickle=False)

        def _read_payload(self):
            payload = self._read_npz()
            feats = payload["feats"]
            session = payload["session"].item() if "session" in payload else 0
            mode = int(payload["mode"].item()) if "mode" in payload else 0
            return feats, session, mode

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                stats = service.batcher.stats_snapshot()
                stats["reloads"] = service.reload_count
                stats["model_source"] = dict(service._source)
                if decoder is not None:
                    stats["decode"] = decoder.stats_snapshot()
                self._json(200, stats)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                if self.path == "/synthesize":
                    feats, session, mode = self._read_payload()
                    buf = io.BytesIO()
                    np.save(buf, service.synthesize(feats, session, mode))
                    self._send_bytes(buf.getvalue())
                elif self.path == "/decode":
                    if decoder is None:
                        self._json(404, {"error": "no decoder loaded "
                                         "(--decoder_artifact or "
                                         "--decoder_ckpt)"})
                        return
                    units, ph = decoder.decode(self._read_npz()["emg"])
                    buf = io.BytesIO()
                    np.savez(buf, units=units, phoneme_logits=ph)
                    self._send_bytes(buf.getvalue())
                elif self.path == "/reload":
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    self._json(200, service.reload(
                        run_dir=body.get("run_dir"), tag=body.get("tag"),
                        artifact=body.get("artifact")))
                elif self.path == "/synthesize_stream":
                    feats, session, mode = self._read_payload()
                    # The iterator first: an artifact raises
                    # NotImplementedError here, before the headers.
                    chunks = service.synthesize_stream(feats, session, mode)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header(
                        "X-Emg-Channels",
                        str(service.synthesizer.generator.num_emg_channels))
                    self.end_headers()
                    for chunk in chunks:
                        raw = np.ascontiguousarray(chunk, np.float32).tobytes()
                        self.wfile.write(len(raw).to_bytes(8, "big"))
                        self.wfile.write(raw)
                        self.wfile.flush()
                    self.wfile.write((0).to_bytes(8, "big"))
                else:
                    self._json(404, {"error": "not found"})
            except NotImplementedError as exc:
                self._json(501, {"error": str(exc)})
            except ServiceOverloadedError as exc:
                self._json(503, {"error": str(exc)},
                           headers=(("Retry-After", "1"),))
            except Exception as exc:  # the server keeps serving
                try:
                    self._json(400, {"error": f"{type(exc).__name__}: {exc}"})
                except OSError:
                    pass  # headers already sent mid-stream, or peer gone

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ste_gan_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run_dir", type=Path,
                     help="GAN training run directory (checkpoint mode)")
    src.add_argument("--artifact", type=Path,
                     help="serving artifact (python -m "
                          "ste_gan_torch.export_generator --serving); no "
                          "checkpoint or config needed, streaming 501")
    ap.add_argument("--tag", default="best")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--bucket", type=int, default=64)
    ap.add_argument("--max_queue", type=int, default=64,
                    help="backpressure high-water mark (503 beyond it)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="serve over the first N cards (checkpoint mode "
                         "only; fewer cards raises)")
    ap.add_argument("--device", type=str, default=None,
                    help="device to serve on (default cuda)")
    ap.add_argument("--decoder_artifact", type=Path, default=None,
                    help="exported EMG-encoder artifact (python -m "
                         "ste_gan_torch.export_emg_encoder); enables POST "
                         "/decode")
    ap.add_argument("--decoder_ckpt", type=Path, default=None,
                    help="EMG-encoder checkpoint (<enc_run>/"
                         "best_val_loss_model.pt); enables POST /decode "
                         "without an export step (needs --run_dir: its "
                         "config.yaml gives the encoder's architecture)")
    ap.add_argument("--decode_min_frames", type=int, default=None,
                    help="override the decoder's minimum 50 Hz frame count "
                         "(normally the artifact's meta file: the "
                         "encoder's relative-position distance + 1)")
    args = ap.parse_args(argv)
    if args.artifact is not None and args.data_parallel > 1:
        raise SystemExit("--data_parallel needs checkpoint mode (--run_dir): "
                         "an exported artifact is a single-device program")
    dev = resolve_device(args.device)
    devices = serving_devices(args.data_parallel, dev)
    if args.decoder_ckpt is not None and args.run_dir is None:
        raise SystemExit("--decoder_ckpt needs --run_dir (its config.yaml "
                         "gives the encoder's architecture); with "
                         "--artifact use --decoder_artifact")
    opts = dict(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                bucket=args.bucket, max_queue=args.max_queue, device=dev)
    if args.artifact is not None:
        service = SynthesisService.from_artifact(args.artifact, **opts)
    else:
        service = SynthesisService.from_run_dir(
            args.run_dir, tag=args.tag, data_parallel=args.data_parallel,
            **opts)
    decoder = None
    if args.decoder_artifact is not None:
        decoder = EMGDecoderService(args.decoder_artifact, bucket=args.bucket,
                                    min_frames=args.decode_min_frames,
                                    device=dev)
    elif args.decoder_ckpt is not None:
        from ste_gan_torch.config import load_config

        decoder = EMGDecoderService.from_checkpoint(
            load_config(config=Path(args.run_dir) / "config.yaml"),
            args.decoder_ckpt, bucket=args.bucket,
            min_frames=args.decode_min_frames, device=dev)
    print(f"warming up (bucket={args.bucket})...", flush=True)
    service.warmup(num_frames=args.bucket, batch_sizes=(1,))
    if decoder is not None:
        decoder.warmup()
    server = make_http_server(service, args.host, args.port, decoder=decoder)
    endpoints = ("POST /synthesize, /synthesize_stream, /reload"
                 + (", /decode" if decoder else ""))
    where = ", ".join(map(str, devices)) if devices else str(dev)
    print(f"serving speech->EMG on http://{args.host}:{args.port} on {where} "
          f"({endpoints}; GET /healthz, /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
