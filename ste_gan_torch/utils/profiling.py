"""Step throughput of the trainer.

Counterpart of ``ste_gan_tpu/utils/profiling.py::StepTimer``: steps/s,
ms/step and EMG channel-samples/s per device over the window between two
logging boundaries, on the host clock. The trainer reads a loss at each
boundary, which waits for the card, so a window holds finished steps.
"""
from __future__ import annotations

import time
from typing import Dict, Optional


class StepTimer:
    def __init__(self, channel_samples_per_step: int, num_devices: int = 1):
        self.channel_samples_per_step = channel_samples_per_step
        self.num_devices = max(1, num_devices)
        self._last_time: Optional[float] = None
        self._last_step: int = 0

    def update(self, step: int) -> Dict[str, float]:
        """Call at logging boundaries; returns throughput scalars for the
        window since the previous call."""
        now = time.perf_counter()
        out: Dict[str, float] = {}
        if self._last_time is not None and step > self._last_step:
            dt = now - self._last_time
            steps = step - self._last_step
            out["perf/steps_per_sec"] = steps / dt
            out["perf/ms_per_step"] = 1e3 * dt / steps
            out["perf/emg_channel_samples_per_sec_per_chip"] = (
                steps * self.channel_samples_per_step / dt / self.num_devices)
        self._last_time = now
        self._last_step = step
        return out
