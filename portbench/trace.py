"""The traced window: ``torch.profiler`` over a short stretch of the cell's
own work, and its reduction to what the per-layer readers take.

The stretch runs twice. First with only the device activity recorded,
which costs the host nothing measurable: the device's busy time (the union
of the intervals in which a kernel, a copy or a fill ran), the operations
launched and the time by name, over the window's host-clock length. Then
with the host's ops recorded too (without shapes: recording them triples
the GAN step's host time), for what needs the host's side:

* the idle gaps (the window less the busy union), each labelled by the
  innermost harness span the host was in at its middle (the window's own
  thread first), summed by label. The harness marks the stretch with a
  ``portbench/window`` span and its calls into the program with
  ``portbench/<label>`` spans (``draw``, ``gather``, ``step``, ``fold``,
  ``convert``). The host runs slower in this pass, so the gaps
  say where the host was, not how long it takes untraced;
* the device time of the kernels launched inside each
  ``GroupedConv1dFn`` forward and backward op (matched by correlation id),
  whatever those kernels are.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "portbench/"
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CONV_OPS = ("GroupedConv1dFn", "GroupedConv1dFnBackward")


@dataclass
class ConvCall:
    op: str
    device_s: float


@dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    conv_calls: List[ConvCall] = field(default_factory=list)
    #: Units of work in the device-only pass and in the pass with the host.
    units: float = 0.0
    host_units: float = 0.0

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> Dict[str, list]:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def union_length(intervals: Sequence[tuple]) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _profile(fn: Callable[[], float], acts) -> Tuple[float, float, list]:
    """Runs ``fn`` under the profiler; returns its units, the window's
    host-clock seconds (ending after the device is done) and the trace's
    events."""
    import time

    import torch

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                units = fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as fp:
            events = json.load(fp)["traceEvents"]
    finally:
        os.unlink(path)
    return float(units), seconds, events


def record(fn: Callable[[], float], cuda: bool) -> Trace:
    """Runs ``fn`` (which returns the units of work it did) twice under
    the profiler, as the module's docstring says, and reduces both."""
    import torch

    A = torch.profiler.ProfilerActivity
    units, seconds, events = (_profile(fn, [A.CUDA]) if cuda
                              else (fn(), 0.0, []))
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
           for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    host_units, _, host_events = _profile(
        fn, [A.CPU, A.CUDA] if cuda else [A.CPU])
    host = reduce(host_events)
    if not cuda:
        return dataclasses.replace(host, units=units, host_units=host_units)
    return Trace(window_s=seconds,
                 busy_s=union_length([(s, e) for s, e, _ in dev]) * 1e-6,
                 launches=len(dev), device_ops=_by_name(dev),
                 idle_gaps=host.idle_gaps, conv_calls=host.conv_calls,
                 units=units, host_units=host_units)


def _by_name(dev) -> List[Tuple[str, float]]:
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, ev in dev:
        by_name[ev["name"][:120]] += (e - s) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def _innermost(spans: List[Tuple[float, float, str, int]], t: float,
               tid) -> Optional[str]:
    best = None
    for s, e, label, span_tid in spans:
        if s <= t <= e:
            key = (span_tid == tid, s)
            if best is None or key > best[0]:
                best = (key, label)
    return None if best is None else best[1]


def reduce(events: List[dict]) -> Trace:
    """The :class:`Trace` of a chrome trace's events (times in us)."""
    complete = [e for e in events if e.get("ph") == "X"]
    window = [e for e in complete if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no portbench/window span")
    w = window[0]
    t0, t1, wtid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w["tid"]

    dev = []
    for e in complete:
        if e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            if s + d > t0 and s < t1:
                dev.append((max(s, t0), min(s + d, t1), e))
    busy = union_length([(s, e) for s, e, _ in dev])
    device_ops = _by_name(dev)

    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e["name"][len(PREFIX):], e["tid"]) for e in complete
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX) and e is not w]
    gaps: Dict[str, float] = defaultdict(float)
    cursor = t0
    for s, e in _merged([(s, e) for s, e, _ in dev]) + [(t1, t1)]:
        if s > cursor:
            label = _innermost(spans, 0.5 * (cursor + s), wtid) or "other"
            gaps[label] += (s - cursor) * 1e-6
        cursor = max(cursor, e)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])

    return Trace(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6,
                 launches=len(dev), device_ops=device_ops,
                 idle_gaps=idle_gaps,
                 conv_calls=_conv_calls(complete, dev, t0, t1))


def _merged(intervals):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _conv_calls(complete, dev, t0, t1) -> List[ConvCall]:
    launches: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    for e in complete:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["tid"]].append((float(e["ts"]),
                                       e["args"]["correlation"]))
    for lst in launches.values():
        lst.sort()
    kernel_s: Dict[int, float] = defaultdict(float)
    for s, e, ev in dev:
        corr = ev.get("args", {}).get("correlation")
        if corr is not None:
            kernel_s[corr] += (e - s) * 1e-6
    calls = []
    for e in complete:
        if e.get("cat") != "cpu_op" or e.get("name") not in CONV_OPS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s < t0 or s > t1:
            continue
        lst = launches.get(e["tid"], [])
        lo = bisect.bisect_left(lst, (s, -1))
        hi = bisect.bisect_right(lst, (s + d, float("inf")))
        device = sum(kernel_s.get(c, 0.0) for _, c in lst[lo:hi])
        calls.append(ConvCall(e["name"], device))
    return calls
