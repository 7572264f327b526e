"""Metric logging: a JSONL file, TensorBoard (tensorboardX) when it is
installed, and stdlib logging.

Counterpart of ``ste_gan_tpu/utils/logging_utils.py``. Scalars go to an
append-only ``metrics.jsonl`` in the run directory (cheap to parse for tests
and tooling) and, when tensorboardX imports, to TensorBoard event files;
figures go to TensorBoard when it is on, else to PNG files in the run
directory.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict


class MetricLogger:
    def __init__(self, run_dir: Path, use_tensorboard: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                logging.info("tensorboardX unavailable; metrics.jsonl only")
            else:
                self._tb = SummaryWriter(str(self.run_dir))

    def scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step), "ts": time.time()}) + "\n")
        self._jsonl.flush()  # survive preemption; tail-able during the run
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def figure(self, tag: str, fig, step: int) -> None:
        """A matplotlib figure: to TensorBoard when it is on, else a PNG
        in the run directory."""
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)
        else:
            safe = tag.replace("/", "_")
            fig.savefig(self.run_dir / f"{safe}_{step}.png")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def setup_run_logging(run_dir: Path) -> logging.Handler:
    """stdout + log.txt file handler (reference: ste_gan/train.py:540-543).
    Returns the file handler so an in-process caller can remove it."""
    logging.getLogger().setLevel(logging.INFO)
    fh = logging.FileHandler(str(Path(run_dir) / "log.txt"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logging.getLogger().addHandler(fh)
    return fh
