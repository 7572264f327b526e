"""Where the time of the full-width train step goes on the card.

    python -m ste_gan_torch.profile_step [--steps 3]

Sets up the main path that ``chip_smoke.py`` times
(:func:`ste_gan_torch.train.gan.main_path`), takes 3 warm-up steps, times
``--steps`` steps with the host clock around ``synchronize``, then traces the
same number of steps with ``torch.profiler`` and prints the device time per
step by kernel (the top 40, then every hand-written kernel of the port), the
traced step's device busy share, and the card's name and power limit. Tracing slows the host, so the traced step's idle share is an
upper bound on the untraced step's; the untraced estimate divides the traced
device time by the untraced wall time of the other window.
"""
from __future__ import annotations

import argparse
import time

import torch

from ste_gan_torch.device import card_line
from ste_gan_torch.train import gan as tgan


#: The CUDA kernels of ``ste_gan_torch/csrc``, listed whatever their rank.
HAND_KERNELS = ("conv_fwd_bf16_kernel", "conv_fwd_kernel", "conv_dx_kernel",
                "conv_dw_partial_kernel", "conv_dw_partial_f32_kernel",
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
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

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
             f"device busy: {busy:.2f} ms/step; traced step idle "
             f"{100 - 100 * busy / traced_ms:.1f} % (measured, upper bound); "
             f"untraced step idle {100 - 100 * busy / wall_ms:.1f} % "
             f"(estimate from the two windows)",
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
