"""The arithmetic of the per-layer metrics. Each metric's own file under
``metrics/`` calls one of these; a reader that finds nothing to read
returns None and the metric is left out of the run's line."""
from __future__ import annotations

from typing import Optional

from portbench import peaks
from portbench.drivers import common
from portbench.reference import nets


def mfu(run, flops_key: str) -> Optional[float]:
    """The window's share of the card's peak: the least time of the model
    FLOPs done (per unit of work, by operation class, from the config
    file, times the units the untraced window completed) over its
    measured length, in percent."""
    per_unit = run.config.get("flops", {}).get(flops_key)
    if not per_unit or not run.window.get("units"):
        return None
    least = peaks.least_seconds(per_unit) * run.window["units"]
    return 100.0 * least / run.window["seconds"]


def idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return run.trace.idle_pct


def untraced_idle_pct(run) -> Optional[float]:
    """100 less the device's busy time per unit of work in the traced
    device-only pass, over the untraced window's seconds per unit, in
    percent: the idle share of the untraced window. The profiler's cost
    per launch stretches a host-bound step's traced window, and with it
    the traced window's idle share, while the busy union hardly moves."""
    t = run.trace
    if (t is None or not t.units or t.busy_s <= 0
            or not run.window.get("units")):
        return None
    per_unit = run.window["seconds"] / run.window["units"]
    return 100.0 * (1.0 - t.busy_s / t.units / per_unit)


def launches_per_unit(run) -> Optional[float]:
    if run.trace is None or not run.trace.units or not run.trace.launches:
        return None
    return run.trace.launches / run.trace.units


def grouped_conv_step_bound_s(config) -> float:
    """The least time of one GAN step's grouped-conv work at the cell's
    shapes: each grouped layer of the three scale discriminators (inputs
    ``T``, ``T/2``, ``T/4`` after the average pooling) on the paired batch
    (fake and real, ``2B`` rows), run forward twice (the discriminator's
    update and the generator's loss), its data gradient twice and its
    weight gradient once (only the discriminator's update takes one);
    operations and bytes by ``peaks.grouped_conv``, bf16."""
    batch, chunk = common.batch_shape(config)
    rows, total = 2 * batch, 0.0
    for scale in range(3):
        length, cin = chunk >> scale, common.sizes(config)["d"]["cin"]
        for cout, k, stride, groups, pad in nets.SMALL_SCALE_SPEC:
            t_out = (length + 2 * pad - k) // stride + 1
            if groups > 1:
                ops, nbytes = peaks.grouped_conv(rows, cin, cout, k, groups,
                                                 length, t_out)
                total += 5 * peaks.bound_ms(nbytes, ops, "bf16")[0] * 1e-3
            length, cin = t_out, cout
    return total


def grouped_conv_roofline(run) -> Optional[float]:
    """The grouped convs' least time over their device time, in percent:
    the work of the steps traced (:func:`grouped_conv_step_bound_s`) over
    the device time of the kernels launched inside ``GroupedConv1dFn``'s
    forward and backward ops in those steps, whatever kernels they are."""
    calls = [] if run.trace is None else run.trace.conv_calls
    device_s = sum(c.device_s for c in calls)
    if not calls or device_s <= 0:
        return None
    least = grouped_conv_step_bound_s(run.config) * run.trace.host_units
    return 100.0 * least / device_s

