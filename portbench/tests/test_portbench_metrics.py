"""The metric arithmetic against numbers worked out by hand."""
import types

import pytest

from portbench import peaks, readers, spec, trace


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _events():
    """A 100 us window: kernels at 10-30 and 20-40 (overlapping), a copy at
    60-70; the host in ``step`` over 0-50 and ``gather`` over 50-100; one
    grouped-conv forward at 5-15 whose launch (correlation 7) ran a 20 us
    kernel."""
    return [
        _ev("portbench/window", "user_annotation", 0, 100),
        _ev("portbench/step", "user_annotation", 0, 50),
        _ev("portbench/gather", "user_annotation", 50, 50),
        _ev("GroupedConv1dFn", "cpu_op", 5, 10,
            **{"Input Dims": [[64, 128, 1024], [256, 32, 37], [], [], [], []],
               "Concrete Inputs": ["", "", "2", "18", "18", "4"]}),
        _ev("cudaLaunchKernel", "cuda_runtime", 8, 1, correlation=7),
        _ev("conv_kernel", "kernel", 10, 20, tid=7, correlation=7),
        _ev("other_kernel", "kernel", 20, 20, tid=7, correlation=8),
        _ev("Memcpy HtoD", "gpu_memcpy", 60, 10, tid=7, correlation=9),
    ]


def test_union_of_intervals():
    assert trace.union_length([(10, 30), (20, 40), (60, 70)]) == 40
    assert trace.union_length([(0, 5), (5, 6)]) == 6
    assert trace.union_length([]) == 0


def test_trace_busy_idle_and_gaps():
    t = trace.reduce(_events())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.idle_pct == pytest.approx(60.0)
    assert t.launches == 3
    gaps = dict(t.idle_gaps)
    # A gap goes to the innermost span at its middle: 0-10 to ``step``,
    # 40-60 (middle 50, where ``gather`` starts) and 70-100 to ``gather``.
    assert gaps["step"] == pytest.approx(10e-6)
    assert gaps["gather"] == pytest.approx(50e-6)
    names = dict(t.device_ops)
    assert names["conv_kernel"] == pytest.approx(20e-6)


def test_conv_call_device_time_by_correlation():
    t = trace.reduce(_events())
    (call,) = t.conv_calls
    assert call.op == "GroupedConv1dFn"
    assert call.device_s == pytest.approx(20e-6)


def test_grouped_conv_step_bound_by_hand():
    config = spec.load_cell("gan_su.train").config
    # The six geometries at 2B = 64 rows as chip_smoke.py's [conv] table
    # gives their bounds (ms; layer 1 bound by operations, layer 2 by
    # bytes), each run as 2 forwards, 2 data and 1 weight gradient.
    by_hand = [0.0402, 0.0201, 0.0100, 0.0202, 0.0102, 0.0052]
    assert readers.grouped_conv_step_bound_s(config) == pytest.approx(
        5 * sum(by_hand) * 1e-3, rel=2e-3)


def test_grouped_conv_roofline_from_the_trace():
    t = trace.reduce(_events())
    t.host_units = 2.0
    run = types.SimpleNamespace(
        trace=t, config=spec.load_cell("gan_su.train").config)
    least = 2 * readers.grouped_conv_step_bound_s(run.config)
    assert readers.grouped_conv_roofline(run) == pytest.approx(
        100.0 * least / 20e-6)


def test_bound_ms_with_tf32():
    ms, by = peaks.bound_ms(3.35e9, 495e12, "tf32")
    assert ms == pytest.approx(1000.0) and by == "operations"
    ms, by = peaks.bound_ms(3.35e12, 1.0, "bf16")
    assert ms == pytest.approx(1000.0) and by == "bytes"
    assert peaks.least_seconds({"bf16": 989e12, "tf32": 495e12,
                                "f32": 67e12}) == pytest.approx(3.0)


def test_untraced_idle_from_busy_per_unit():
    t = trace.reduce(_events())
    t.units = 4.0
    # 4 units in the traced pass, busy 40 us: 10 us a unit; the untraced
    # window did 100 units in 4 ms, 40 us a unit: 75 % idle.
    run = types.SimpleNamespace(trace=t, window={"units": 100,
                                                 "seconds": 4e-3})
    assert t.busy_s == pytest.approx(40e-6)
    assert readers.untraced_idle_pct(run) == pytest.approx(75.0)
    run.trace = None
    assert readers.untraced_idle_pct(run) is None


def test_mfu_from_config_flops():
    run = types.SimpleNamespace(
        config={"flops": {"step": {"bf16": 989e12 * 0.01}}},
        window={"units": 50, "seconds": 10.0})
    # 10 ms least time a step, 50 steps in 10 s: 5 %.
    assert readers.mfu(run, "step") == pytest.approx(5.0)
    assert readers.mfu(run, "missing") is None
