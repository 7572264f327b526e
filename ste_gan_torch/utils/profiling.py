"""Step throughput of the trainer, and the port's spans and counters.

:class:`StepTimer` is the counterpart of
``ste_gan_tpu/utils/profiling.py::StepTimer``: steps/s, ms/step and EMG
channel-samples/s per device over the window between two logging
boundaries, on the host clock. The trainer reads a loss at each boundary,
which waits for the card, so a window holds finished steps. It also gives
the host milliseconds a step of every span that ran in the window.

Spans and counters: ``with span("gan/g_forward"):`` adds the block's host
seconds (``time.perf_counter``) and one call to an in-memory table keyed by
the span's name; :func:`add` adds a plain value (``synth/batches``, 1) to
the same table. :func:`counters` snapshots the table as ``{name: (total,
calls)}``, :func:`since` gives what was added after a snapshot, and
:func:`reset` clears it. While :func:`tracing` is on, a span also opens
``torch.profiler.record_function("ste_gan/" + name)``, so a running
profiler records it in the same trace as the card's kernels, copies and
fills; spans nest as the calls do. With tracing off a span costs two clock
reads and a dict update under a lock: no torch call, no wait for the card.

A span's host time is the time the host spends in the block: the launches
it queues, not the card's work, except where the block itself waits
(``synth/fetch``, ``feed/wait``).

A span opened inside an autograd function's ``backward`` (``enc/lfm2/*``,
``enc/mla/attention`` and ``enc/moe/experts``, which time their backward
under the forward's name) runs on autograd's thread on the card, so the
trace attributes the backward's kernels to it there.

The synthesis loop's (``infer.py`` ``convert_dataset``), per batch: spans
``synth/pack``, ``synth/h2d``, ``synth/forward``, ``synth/fetch`` (the
wait for the card) and ``synth/unpack``; counters ``synth/batches``,
``synth/valid_frames``, ``synth/computed_frames``; on a card, for each
batch after the first of a pass, ``synth/ahead`` (queued while the batch
before was still unfinished on the card) or ``synth/behind`` (queued
after it had finished). The generator's CUDA graphs add
``synth/graph_replays``, ``synth/graph_eager`` and
``synth/graph_captures`` (``infer_graphs.py``).

The encoders' LFM2, latent-attention and mixture-of-experts spans and
counters (``models/lfm2.py``; ``models/deepseek_v3.py``; ``models/moe.py``,
both blocks, the capacity block's in its forward only and counted over the
whole batch):

* ``enc/lfm2/short_conv``: the gated short convolution (``B * x``, the
  causal depthwise conv, ``C *``), forward and backward, without its
  projections;
* ``enc/lfm2/attention``: the q/k RMSNorm, RoPE and causal GQA attention,
  forward and backward, without the projections;
* ``enc/mla/attention``: multi-head latent attention's latent RMSNorm, and
  its RoPE and causal attention core, forward and backward;
  ``enc/mla/project``: its four projections (``q_proj``,
  ``kv_a_proj_with_mqa``, ``kv_b_proj``, ``o_proj``), forward;
* ``enc/moe/route``: router, scores, top-k and the picks' order or slots;
  ``enc/moe/experts``: the expert products (``DroplessMoE``'s grouped
  ones forward and backward); ``enc/moe/combine``: the gated sum of each
  token's picks; ``enc/moe/shared``: ``DroplessMoE``'s shared experts
  (DeepSeek-V3's), forward;
* ``enc/moe/bias``: the expert biases' update after the optimizer step;
* counters ``moe/picks`` (a host number) and ``moe/max_load`` (summed on
  the card in int64, read by :func:`counters`), each added once per MoE
  layer and forward; ``moe/dropped``, the picks over the capacity, in the
  capacity block only (the dropless one computes every pick).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

#: Prefix of the spans' names in a profiler trace.
PREFIX = "ste_gan/"

#: name -> [total, calls]: host seconds of a span, or a counter's sum.
#: Spans close on more than one thread (a server's batcher, autograd's in a
#: recompute), so updates and snapshots hold the lock.
_TABLE: Dict[str, list] = {}
_LOCK = threading.Lock()
_TRACING = False


def tracing(enabled: bool) -> bool:
    """Turns the spans' profiler ranges on or off; returns the previous
    setting."""
    global _TRACING
    previous, _TRACING = _TRACING, bool(enabled)
    return previous


class span:
    """``with span(name):`` times the block into the table (and, while
    :func:`tracing` is on, marks it ``ste_gan/<name>`` in the trace)."""

    __slots__ = ("name", "_start", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._range = None
        if _TRACING:
            import torch

            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        add(self.name, time.perf_counter() - self._start)
        if self._range is not None:
            self._range.__exit__(*exc)


def add(name: str, value) -> None:
    """Adds ``value`` to the counter ``name`` (and one to its calls). A
    tensor ``value`` (a count the card computed) is summed on its device,
    with no wait for it; :func:`counters` reads the sum."""
    with _LOCK:
        entry = _TABLE.get(name)
        if entry is None:
            _TABLE[name] = [value, 1]
        else:
            entry[0] = entry[0] + value
            entry[1] += 1


def counters() -> Dict[str, Tuple[float, int]]:
    """A snapshot of the table: ``{name: (total, calls)}``. A counter
    summed on the device is read here, one wait for the card per such
    counter."""
    with _LOCK:
        return {name: (float(entry[0]), entry[1])
                for name, entry in _TABLE.items()}


def since(before: Dict[str, Tuple[float, int]]
          ) -> Dict[str, Tuple[float, int]]:
    """What the table gained after the snapshot ``before``: the names
    called since, with their added totals and calls."""
    out = {}
    for name, (total, calls) in counters().items():
        t0, c0 = before.get(name, (0.0, 0))
        if calls > c0:
            out[name] = (total - t0, calls - c0)
    return out


def reset() -> None:
    """Clears the table."""
    with _LOCK:
        _TABLE.clear()


class StepTimer:
    def __init__(self, channel_samples_per_step: int, num_devices: int = 1):
        self.channel_samples_per_step = channel_samples_per_step
        self.num_devices = max(1, num_devices)
        self._last_time: Optional[float] = None
        self._last_step: int = 0
        self._last_counters = counters()

    def update(self, step: int) -> Dict[str, float]:
        """Call at logging boundaries; returns throughput scalars for the
        window since the previous call, with ``perf/host_ms/<span>``: each
        span's host milliseconds a step over the window."""
        now = time.perf_counter()
        spans = since(self._last_counters)
        out: Dict[str, float] = {}
        if self._last_time is not None and step > self._last_step:
            dt = now - self._last_time
            steps = step - self._last_step
            out["perf/steps_per_sec"] = steps / dt
            out["perf/ms_per_step"] = 1e3 * dt / steps
            out["perf/emg_channel_samples_per_sec_per_chip"] = (
                steps * self.channel_samples_per_step / dt / self.num_devices)
            out.update({f"perf/host_ms/{name}": 1e3 * total / steps
                        for name, (total, _) in spans.items()})
        self._last_time = now
        self._last_step = step
        self._last_counters = counters()
        return out
