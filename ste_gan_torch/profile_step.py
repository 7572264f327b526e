"""Where the time of the full-width train step goes on the card.

    python -m ste_gan_torch.profile_step [--steps 3]

Sets up the main path that ``chip_smoke.py`` times
(:func:`ste_gan_torch.train.gan.main_path`), takes 3 warm-up steps, times
``--steps`` steps with the host clock around ``synchronize`` and prints the
host milliseconds a step of each phase's span (``utils/profiling.py``),
then traces the same number of steps with ``torch.profiler`` and prints the
device time per step by kernel (the top 40, then every hand-written kernel
of the port) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import time

import torch

from ste_gan_torch.device import card_line
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.utils import profiling


#: The CUDA kernels of ``ste_gan_torch/csrc``, listed whatever their rank.
HAND_KERNELS = ("conv_fwd_wgmma_kernel", "conv_dx_wgmma_kernel",
                "conv_weight_layout_kernel", "conv_fwd_kernel",
                "conv_dw_wgmma_kernel", "conv_dw_partial_f32_kernel",
                "conv_dw_reduce_kernel", "adamw_multi_tensor_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)

    card = card_line()
    _, _, state, step, batch = tgan.main_path()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    before = profiling.counters()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    phases = profiling.since(before)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    # Device-side events only (kernels, copies): the CPU-side ops carry
    # the device time of their kernels again.
    kernel_rows = sorted(
        ((e.key, e.count, _device_us(e) / 1e3 / args.steps)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda r: -r[2])
    busy = sum(r[2] for r in kernel_rows)
    lines = [f"card: {card}",
             f"step: {wall_ms:.2f} ms (host clock, untraced), "
             f"{traced_ms:.2f} ms traced",
             "host ms/step by span (untraced):"]
    lines += [f"{1e3 * total / args.steps:9.3f}  {name}"
              for name, (total, _) in sorted(phases.items())]
    lines += [f"device busy: {busy:.2f} ms/step (traced)",
              f"{'ms/step':>9}  {'share':>6}  {'calls/step':>10}  kernel"]
    def row(name, count, ms):
        return (f"{ms:9.3f}  {100 * ms / busy:5.1f}%  "
                f"{count / args.steps:10.1f}  {name[:110]}")

    lines += [row(*r) for r in kernel_rows[:40]]
    lines.append("hand-written kernels of the port (ste_gan_torch/csrc):")
    lines += [row(*r) for r in kernel_rows
              if any(k in r[0] for k in HAND_KERNELS)]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
