"""Readings of the program's own spans and counters
(``ste_gan_torch/utils/profiling.py``) in a cell's run, for the per-layer
metrics of its phases.

Two short stretches of the cell's own traced work (the driver's
``traced``: the mix's ``trace_steps`` steps or ``trace_passes`` passes),
run after the harness's traced window, each once per run:

* :func:`untraced`: with the profiler off, the host clock around it
  (ending in ``synchronize``) and the program's counters snapshotted before
  and after: host seconds and calls of each span, and the counters' sums;
* :func:`traced`: under ``torch.profiler`` (host ops and the device) with
  the program's tracing on, so its spans are ``ste_gan/<name>`` ranges in
  the same trace as the kernels, reduced by :func:`reduce`; at most
  ``TRACED_STEPS`` steps, since a GAN step leaves some 54,000 events,
  about 2 s of export and reduction on an H100 machine's host.

A program without those counters (one from before they were added) gives
None from both, and the metrics that read them are left out of the line.

    python3 -m portbench.phases --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and its untraced window with the counters read
around the window, then the traced stretch three times each with the
program's spans off and on in turns (what they cost the traced host),
times an empty span, reads the cell's per-layer metrics, and prints the
breakdown of the last pass with spans on as one JSON object.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import peaks, spec, trace
from portbench.drivers import common

#: Prefix of the program's spans in a trace.
PROGRAM = "ste_gan/"
#: Bytes a parameter of one AdamW update: p, g, m, v read and p, m, v
#: written, f32.
ADAMW_BYTES = 28
#: f32 operations a parameter of one AdamW update (two moments, the bias
#: corrections, square root, quotient, weight decay and step).
ADAMW_OPS = 16
#: Steps of a training cell's pass with the program's spans on: AdamW's
#: device time a step repeats within a few microseconds.
TRACED_STEPS = 4


def program_profiling():
    """The program's profiling module, if it has spans and counters."""
    try:
        from ste_gan_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("counters", "since",
                                                "tracing")):
        return None
    return profiling


def _once(run, key: str, fn):
    key = "phases." + key
    if key not in run.stash:
        run.stash[key] = fn(run)
    return run.stash[key]


def untraced(run) -> Optional[Dict]:
    """``{"units", "seconds", "counters"}`` of an untraced stretch of the
    cell's traced work; counters as ``{name: (total, calls)}``."""
    return _once(run, "untraced", _untraced)


def _untraced(run) -> Optional[Dict]:
    prof = program_profiling()
    if prof is None:
        return None
    drv = spec.driver(run.cell.driver)
    run.sync()
    before = prof.counters()
    t0 = time.perf_counter()
    units = drv.traced(run)
    run.sync()
    seconds = time.perf_counter() - t0
    return {"units": float(units), "seconds": seconds,
            "counters": prof.since(before)}


@dataclass
class ProgramTrace:
    window_s: float
    busy_s: float
    units: float
    #: Idle seconds by the innermost span at the gap's middle.
    idle_gaps: List[Tuple[str, float]]
    #: Device seconds and operations by the program span their launch
    #: fell in (``other`` outside every one).
    device_s: Dict[str, float]
    launches: Dict[str, int]

    def breakdown(self) -> Dict[str, list]:
        return {"window_s": self.window_s, "busy_s": self.busy_s,
                "units": self.units,
                "idle_gaps": [[n, s] for n, s in self.idle_gaps],
                "device_s": sorted(([n, s] for n, s in self.device_s.items()),
                                   key=lambda kv: -kv[1]),
                "launches": sorted(([n, c] for n, c in self.launches.items()),
                                   key=lambda kv: -kv[1])}


def traced(run) -> Optional[ProgramTrace]:
    """The cell's traced work once more, under the profiler with the
    program's spans on, reduced."""
    return _once(run, "traced", _traced)


def _traced(run) -> Optional[ProgramTrace]:
    prof = program_profiling()
    if prof is None:
        return None
    units, _, events = profile(run, prof, True, TRACED_STEPS)
    return reduce(events, units)


class _Steps:
    """``run`` with the mix's ``trace_steps`` cut to ``steps``."""

    def __init__(self, run, steps: int):
        self._run = run
        self.traffic = dict(run.traffic, trace_steps=min(
            steps, int(run.traffic["trace_steps"])))

    def __getattr__(self, name):
        return getattr(self._run, name)


def profile(run, prof, spans: bool, steps: Optional[int] = None):
    """``trace._profile`` of the driver's traced work (host ops and, on
    the card, the device) with the program's spans on or off; a training
    mix's ``steps`` steps where given."""
    import torch

    A = torch.profiler.ProfilerActivity
    drv = spec.driver(run.cell.driver)
    work = (_Steps(run, steps) if steps and "trace_steps" in run.traffic
            else run)
    previous = prof.tracing(spans)
    try:
        return trace._profile(lambda: drv.traced(work),
                              [A.CPU, A.CUDA] if run.cuda else [A.CPU])
    finally:
        prof.tracing(previous)


def _innermost_at(spans: Sequence[tuple], times: Sequence[float]
                  ) -> List[Optional[tuple]]:
    """For the nested ``(start, end, label)`` spans of one thread, the
    innermost ``(start, label)`` covering each time, or None."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out: List[Optional[tuple]] = [None] * len(times)
    stack: List[tuple] = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[q] = (stack[-1][0], stack[-1][2])
    return out


def _label(by_tid: Dict, wtid, times: Sequence[float]) -> List[str]:
    """The innermost span at each time, the window's thread first, then
    the latest-starting one of another thread; ``other`` where none."""
    found = {tid: _innermost_at(spans, times) for tid, spans in by_tid.items()}
    window = found.get(wtid, [None] * len(times))
    labels = []
    for q in range(len(times)):
        own = window[q]
        if own is None:
            others = [f[q] for tid, f in found.items()
                      if tid != wtid and f[q] is not None]
            own = max(others) if others else None
        labels.append("other" if own is None else own[1])
    return labels


def reduce(events: List[dict], units: float = 0.0) -> ProgramTrace:
    """The idle gaps of a chrome trace's ``portbench/window`` labelled by
    the innermost program (``ste_gan/<name>``) or harness (``<label>``)
    span, and each device operation charged to the innermost program span
    on the window's thread at its launch: the runtime call with its
    correlation id, on any thread (the backward launches from autograd's
    thread while the window's thread waits in its span)."""
    complete = [e for e in events if e.get("ph") == "X"]
    window = [e for e in complete if e.get("name") == trace.WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no portbench/window span")
    w = window[0]
    t0, t1, wtid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w["tid"]

    dev = []
    for e in complete:
        if e.get("cat") in trace.DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            if s + d > t0 and s < t1:
                dev.append((max(s, t0), min(s + d, t1), e))

    spans, program = defaultdict(list), []
    for e in complete:
        name = e.get("name", "")
        if e.get("cat") != "user_annotation" or e is w:
            continue
        s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if name.startswith(PROGRAM):
            spans[e["tid"]].append((s, end, name))
            if e["tid"] == wtid:
                program.append((s, end, name))
        elif name.startswith(trace.PREFIX):
            spans[e["tid"]].append((s, end, name[len(trace.PREFIX):]))

    gaps, mids = [], []
    cursor = t0
    for s, e in trace._merged([(s, e) for s, e, _ in dev]) + [(t1, t1)]:
        if s > cursor:
            gaps.append(s - cursor)
            mids.append(0.5 * (cursor + s))
        cursor = max(cursor, e)
    idle: Dict[str, float] = defaultdict(float)
    for label, g in zip(_label(spans, wtid, mids), gaps):
        idle[label] += g * 1e-6

    launch = {e["args"]["correlation"]: float(e["ts"]) for e in complete
              if e.get("cat") in trace.LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    at = [launch.get(ev.get("args", {}).get("correlation"), -1.0)
          for _, _, ev in dev]
    device_s: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for (s, e, _), found in zip(dev, _innermost_at(program, at)):
        label = "other" if found is None else found[1]
        device_s[label] += (e - s) * 1e-6
        launches[label] += 1

    return ProgramTrace(
        window_s=(t1 - t0) * 1e-6,
        busy_s=trace.union_length([(s, e) for s, e, _ in dev]) * 1e-6,
        units=float(units),
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1]),
        device_s=dict(device_s), launches=dict(launches))


# ---------------------------------------------------------------------------
# The readers' arithmetic
# ---------------------------------------------------------------------------


def _total(counters: Dict, name: str) -> float:
    return counters.get(name, (0.0, 0))[0]


def host_ms_per_unit(run, *names: str) -> Optional[float]:
    """Host milliseconds a unit of work (a step) in the spans ``names``
    over the untraced stretch; None where none of them ran."""
    u = untraced(run)
    if u is None or not u["units"] or not any(n in u["counters"]
                                              for n in names):
        return None
    return 1e3 * sum(_total(u["counters"], n) for n in names) / u["units"]


def padding_pct(run) -> Optional[float]:
    """100 less the share of the frames synthesised that were valid."""
    u = untraced(run)
    computed = 0.0 if u is None else _total(u["counters"],
                                            "synth/computed_frames")
    if not computed:
        return None
    return 100.0 * (1.0 - _total(u["counters"], "synth/valid_frames")
                    / computed)


def host_ms_per_batch(run) -> Optional[float]:
    """The stretch's milliseconds less its ``synth/fetch`` waits for the
    device, over the batches."""
    u = untraced(run)
    batches = 0.0 if u is None else _total(u["counters"], "synth/batches")
    if not batches:
        return None
    return 1e3 * (u["seconds"] - _total(u["counters"], "synth/fetch")) / (
        batches)


def adamw_step_bound_s(config) -> float:
    """The least time of one GAN step's two AdamW updates: every parameter
    of the reference's generator and discriminator (on the meta device)
    read and written once, f32."""
    n = sum(p.numel() for m in common.reference_modules(config, "gd").values()
            for p in m.parameters())
    return peaks.bound_ms(ADAMW_BYTES * n, ADAMW_OPS * n, "f32")[0] * 1e-3


def adamw_roofline(run) -> Optional[float]:
    """The updates' least time over the device time of the operations
    launched in the ``adamw`` span, in percent, over the steps traced."""
    t = traced(run)
    device_s = 0.0 if t is None else t.device_s.get(PROGRAM + "adamw", 0.0)
    if device_s <= 0 or not t.units:
        return None
    return 100.0 * adamw_step_bound_s(run.config) * t.units / device_s


# ---------------------------------------------------------------------------
# The breakdown of a cell by phase
# ---------------------------------------------------------------------------


def span_cost_us(prof, n: int = 20000) -> Dict[str, float]:
    """Host microseconds of one empty span with tracing off, and with
    tracing on inside a running profiler (host ops only)."""
    import torch

    def per_span() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with prof.span("cost_probe"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    off = per_span()
    previous = prof.tracing(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            on = per_span()
    finally:
        prof.tracing(previous)
    return {"off": off, "on_profiled": on}


def main(argv=None) -> int:
    import argparse
    import gc
    import json
    import sys

    from portbench import run as run_mod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    run_mod._cache_env()
    import torch

    prof = program_profiling()
    if prof is None or not torch.cuda.is_available():
        print("portbench.phases: needs a card and a program with spans",
              file=sys.stderr)
        return 2
    run = run_mod.Run(cell, args.seed, args.seconds, torch.device("cuda"))
    drv = spec.driver(cell.driver)
    drv.setup(run)
    run.sync()
    before = prof.counters()
    e2e = drv.window(run)
    window = dict(run.window, counters=prof.since(before), end_to_end=e2e)

    # The traced work with the program's spans off and on in turns, the
    # last pass with them on reduced.
    passes, turns = [], (False, True, True, False, False, True)
    for i, spans in enumerate(turns):
        gc.collect()
        units, seconds, events = profile(run, prof, spans)
        passes.append({"spans": spans, "units": units, "seconds": seconds})
        if i < len(turns) - 1:
            del events
    out = {"workload": cell.name, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), "window": window,
           "traced_passes": passes,
           "spans_on": reduce(events, units).breakdown(),
           "harness_gaps": trace.reduce(events).idle_gaps,
           "span_cost_us": span_cost_us(prof)}
    del events
    gc.collect()
    out["metrics"] = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(run)
        if value is not None:
            out["metrics"][m["name"]] = value
    out["stretch"] = untraced(run)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
