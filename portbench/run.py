"""One run of one benchmark cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A fresh process: it builds the program's kernels or finds them in the
checkout's cache, makes the cell's weights and inputs on the card from
``--seed``, runs the cell's first steps (which the reference later
follows) and its warm-up, then measures for ``--seconds`` with the host
clock, the window ending in ``torch.cuda.synchronize()``. ``--trace 1``
adds a short window under ``torch.profiler`` and reports the per-layer
metrics instead of the end-to-end ones. Then the program's state is
freed and the plain reference judges what the timed path produced.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``breakdown`` in a
traced run, the numbers read but not compared as ``readings``, and
``checks`` last); each number compared is also printed
beside its limit as the last lines of standard error. Without a card, or
with fewer than the cell asks for, the run prints no result and exits 2;
if JAX or the JAX package was loaded, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Build and kernel caches of the program and its libraries, at fixed
#: paths inside the checkout.
CACHE = ROOT / "build" / "portbench_cache"


def _cache_env() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)


class Run:
    """What one run carries from set-up through the window to the check.
    Drivers keep their objects in ``stash``; ``window`` holds the work and
    seconds of the measured window, ``trace`` the reduced traced window."""

    def __init__(self, cell, seed: int, seconds: float, device):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.tracing = False
        self.stash: Dict[str, Any] = {}
        self.window: Dict[str, float] = {}
        self.trace = None
        self.marks: List[Tuple[str, float]] = []

    def mark(self, label: str) -> None:
        """Records the seconds since the process started, after waiting
        for the card: where set-up spends its time."""
        self.sync()
        self.marks.append((label, time.perf_counter() - T_START))

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def span(self, label: str):
        """A ``portbench/<label>`` span in a traced window, else nothing."""
        if not self.tracing:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("portbench/" + label)

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args: argparse.Namespace, overrides: Optional[dict] = None,
            device: Optional[str] = None) -> Tuple[int, Optional[dict],
                                                    List[str]]:
    """Runs the cell; returns ``(exit code, result, check lines)``.
    ``device`` other than ``cuda`` (the tests' CPU runs) skips the look for
    a card."""
    from portbench import spec

    cell = spec.load_cell(args.workload, overrides=overrides)
    _cache_env()
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell needs {cell.chips} CUDA device(s), "
                  f"found {have}", file=sys.stderr)
            return 2, None, []
        device = "cuda"
    dev = torch.device(device)
    run = Run(cell, args.seed, args.seconds, dev)
    drv = spec.driver(cell.driver)
    run.mark("torch")

    drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - T_START
    print("portbench set-up: " + ", ".join(f"{label} {t:.2f} s"
                                           for label, t in run.marks),
          file=sys.stderr, flush=True)
    e2e = drv.window(run)
    e2e["setup_s"] = setup_s
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if args.trace:
        from portbench import trace as tr

        run.tracing = True
        run.trace = tr.record(lambda: drv.traced(run), run.cuda)
        run.tracing = False
        for m in cell.per_layer:
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = run.trace.breakdown()
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": m["unit"]}
    peak = (int(torch.cuda.max_memory_allocated()) if run.cuda else 0)
    drv.release(run)
    if run.cuda:
        torch.cuda.empty_cache()
    checks = drv.check(run)
    correct = all(v <= lim for _, v, lim in checks)
    lines = [f"check {name} {value!r} limit {lim!r}"
             for name, value, lim in checks]

    from portbench.isolation import forbidden_loaded

    found = forbidden_loaded()
    if found:
        print("portbench: the run loaded " + ", ".join(found),
              file=sys.stderr)
        return 3, None, lines
    devinfo = {"platform": "gpu" if run.cuda else dev.type,
               "kind": (torch.cuda.get_device_name(0) if run.cuda
                        else dev.type),
               "count": cell.chips if run.cuda else 1,
               "memory_peak_bytes": peak}
    if run.trace is not None:
        devinfo["busy_s"] = run.trace.busy_s
        devinfo["window_s"] = run.trace.window_s
    result = {"correct": bool(correct),
              "attempted": int(run.window.get("attempted", 0)),
              "failed": int(run.window.get("failed", 0)),
              "metrics": metrics, "device": devinfo}
    if breakdown is not None:
        result["breakdown"] = breakdown
    limited = {name for name, _, _ in checks}
    readings = {k: float(v) for k, v in run.stash.get("numbers", {}).items()
                if k not in limited and isinstance(v, (int, float))}
    if readings:
        result["readings"] = readings
    result["checks"] = {name: {"value": value, "limit": lim}
                        for name, value, lim in checks}
    return 0, result, lines


def main(argv=None) -> int:
    args = parse(argv)
    code, result, lines = execute(args)
    if result is None:
        for line in lines:
            print(line, file=sys.stderr)
        return code
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
