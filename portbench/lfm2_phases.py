"""Readings of the LFM2 encoder cell's program spans and counters for its
kernel rooflines and its routing.

:func:`span_device_s`: the cell's traced work once more (``phases.TRACED_
STEPS`` steps) under ``torch.profiler`` with the program's spans on, each
device operation charged to the innermost program span open on the thread
that launched it at its launch. The backward's spans (``enc/lfm2/*`` and
``enc/moe/experts``, opened inside autograd functions) run on autograd's
thread on the card, which ``phases.reduce`` (the window's thread only)
does not look at. The program's counters are read around the same pass.

A program without the spans or counters gives None, and the metrics that
read them are left out of the line.

The work each roofline counts, per step at the cell's shapes:

* ``moe_expert_roofline``: the expert products' operations, 3 forward and
  6 backward products of ``2 * picks * D * F`` over the sparse layers'
  picks (``moe/picks``), at the bf16 peak, over the device time under
  ``enc/moe/experts``;
* ``short_conv_roofline``: the gated conv's bytes, each input read once
  and each output written once: forward ``B | C | x`` in (``3 N D``) and
  ``y`` out (``N D``); backward ``dy`` and ``B | C | x`` in, ``dB | dC |
  dx`` out (``7 N D``); ``22 N D`` bytes a conv layer at 2 bytes a value,
  ``N`` the step's frames, over the device time under
  ``enc/lfm2/short_conv``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from portbench import peaks, phases, trace

EXPERTS = phases.PROGRAM + "enc/moe/experts"
SHORT_CONV = phases.PROGRAM + "enc/lfm2/short_conv"
#: Grouped products of the experts' SwiGLU a step: 3 forward, 6 backward.
EXPERT_PRODUCTS = 9
#: Values of ``N x D`` the gated conv reads and writes a layer and step.
SHORT_CONV_VALUES = 22


def by_span(events: List[dict]) -> Dict[str, float]:
    """Device seconds in the ``portbench/window`` span by the innermost
    program span open on the launching thread at each operation's launch
    (``other`` outside every one)."""
    complete = [e for e in events if e.get("ph") == "X"]
    window = [e for e in complete if e.get("name") == trace.WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no portbench/window span")
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    spans = defaultdict(list)
    for e in complete:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(
                phases.PROGRAM):
            s = float(e["ts"])
            spans[e["tid"]].append((s, s + float(e["dur"]), name))
    launch = {e["args"]["correlation"]: (float(e["ts"]), e["tid"])
              for e in complete if e.get("cat") in trace.LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    by_tid = defaultdict(list)
    for e in complete:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= t0 or s >= t1:
            continue
        seconds = (min(s + d, t1) - max(s, t0)) * 1e-6
        at = launch.get(e.get("args", {}).get("correlation"))
        if at is None:
            by_tid[None].append((-1.0, seconds))
        else:
            by_tid[at[1]].append((at[0], seconds))
    out: Dict[str, float] = defaultdict(float)
    for tid, ops in by_tid.items():
        found = phases._innermost_at(spans.get(tid, []), [t for t, _ in ops])
        for (_, seconds), f in zip(ops, found):
            out["other" if f is None else f[1]] += seconds
    return dict(out)


def span_device_s(run) -> Optional[Dict]:
    """``{"units", "device_s", "counters"}`` of one traced pass with the
    program's spans on (cached on the run)."""
    key = "lfm2_phases.traced"
    if key not in run.stash:
        run.stash[key] = _span_device_s(run)
    return run.stash[key]


def _span_device_s(run) -> Optional[Dict]:
    prof = phases.program_profiling()
    if prof is None or not run.cuda:
        return None
    before = prof.counters()
    units, _, events = phases.profile(run, prof, True, phases.TRACED_STEPS)
    counters = prof.since(before)
    return {"units": units, "device_s": by_span(events),
            "counters": counters}


def _params(run) -> Dict:
    from portbench.drivers.enc_train_lfm2 import encoder_params

    return encoder_params(run.config)


def step_frames(run) -> int:
    """The frames (tokens) of a step: the fold's windows times the frames
    of a window."""
    window = 8 * int(run.config["train"]["seq_len"])
    return -(-int(run.traffic["max_len"]) // window) * (window // 16)


def moe_expert_roofline(run) -> Optional[float]:
    t = span_device_s(run)
    if t is None:
        return None
    device_s = t["device_s"].get(EXPERTS, 0.0)
    picks = t["counters"].get("moe/picks", (0.0, 0))[0]
    if device_s <= 0 or picks <= 0:
        return None
    p = _params(run)
    ops = (EXPERT_PRODUCTS * 2.0 * picks * p["hidden_size"]
           * p["moe_intermediate_size"])
    return 100.0 * ops / peaks.PEAK_OPS_PER_S["bf16"] / device_s


def short_conv_roofline(run) -> Optional[float]:
    t = span_device_s(run)
    if t is None or not t["units"]:
        return None
    device_s = t["device_s"].get(SHORT_CONV, 0.0)
    if device_s <= 0:
        return None
    p = _params(run)
    layers = list(p["layer_types"])[:p["num_hidden_layers"]].count("conv")
    nbytes = (SHORT_CONV_VALUES * 2 * step_frames(run) * p["hidden_size"]
              * layers * t["units"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / device_s


def load_imbalance(run) -> Optional[float]:
    """The most-loaded expert's picks over the mean load, over the sparse
    layers and the untraced stretch's steps: ``moe/max_load * E /
    moe/picks`` (1 is even)."""
    u = phases.untraced(run)
    if u is None:
        return None
    picks = u["counters"].get("moe/picks", (0.0, 0))[0]
    top = u["counters"].get("moe/max_load", (0.0, 0))[0]
    if picks <= 0:
        return None
    return top * _params(run)["num_experts"] / picks
