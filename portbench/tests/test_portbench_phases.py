"""The readings of the program's spans and counters (``phases.py``)
against numbers worked out by hand, and on tiny CPU runs."""
import types

import pytest

from portbench import phases, readers, spec, trace
from portbench.drivers import common
from portbench.tests.test_portbench_metrics import _ev, _events
from portbench.tests.tiny import execute, tiny

GAN_HOST = ("g_forward_host_ms.gan_train", "d_update_host_ms.gan_train",
            "g_update_host_ms.gan_train", "optim_host_ms.gan_train",
            "feed_wait_ms.gan_train")


def _program_events():
    """The window of ``test_portbench_metrics._events`` with the program's
    spans inside ``step``: ``gan/g_update`` over 0-40 holding
    ``gan/g_backward`` over 20-40, and ``adamw`` over 40-50. The 20-40
    kernel (correlation 8) is launched at 25 from autograd's thread (tid
    2), while the window's thread sits in ``gan/g_backward``; the copy
    (correlation 9) at 45, in ``adamw``."""
    return _events() + [
        _ev("ste_gan/gan/g_update", "user_annotation", 0, 40),
        _ev("ste_gan/gan/g_backward", "user_annotation", 20, 20),
        _ev("ste_gan/adamw", "user_annotation", 40, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 25, 1, tid=2, correlation=8),
        _ev("cudaMemcpyAsync", "cuda_runtime", 45, 1, correlation=9),
    ]


def test_gaps_take_the_innermost_program_span():
    t = phases.reduce(_program_events(), units=2)
    gaps = dict(t.idle_gaps)
    # 0-10 (middle 5) in g_update; 40-60 (middle 50, where adamw ends and
    # gather starts: the later start is the inner) in gather; 70-100 in
    # gather.
    assert gaps["ste_gan/gan/g_update"] == pytest.approx(10e-6)
    assert gaps["gather"] == pytest.approx(50e-6)
    assert t.busy_s == pytest.approx(40e-6) and t.units == 2


def test_device_time_goes_to_the_span_of_its_launch():
    t = phases.reduce(_program_events())
    # conv_kernel (correlation 7) launched at 8 in g_update; the 20-40
    # kernel from autograd's thread at 25, while the window's thread is in
    # g_backward; the copy at 45 in adamw.
    assert t.device_s == pytest.approx({"ste_gan/gan/g_update": 20e-6,
                                        "ste_gan/gan/g_backward": 20e-6,
                                        "ste_gan/adamw": 10e-6})
    assert t.launches == {"ste_gan/gan/g_update": 1,
                          "ste_gan/gan/g_backward": 1, "ste_gan/adamw": 1}


def test_a_span_on_another_thread_labels_only_where_the_window_has_none():
    events = [_ev("portbench/window", "user_annotation", 0, 100),
              _ev("ste_gan/feed/wait", "user_annotation", 0, 30),
              _ev("ste_gan/gan/ema", "user_annotation", 10, 80, tid=3),
              _ev("k", "kernel", 30, 40, tid=7)]
    gaps = dict(phases.reduce(events).idle_gaps)
    assert gaps == pytest.approx({"ste_gan/feed/wait": 30e-6,
                                  "ste_gan/gan/ema": 30e-6})


def test_innermost_of_nested_spans():
    spans = [(0, 10, "a"), (2, 4, "b"), (5, 8, "c"), (5, 6, "d")]
    got = phases._innermost_at(spans, [9, 1, 3, 5.5, 7, 11, 4])
    assert [g and g[1] for g in got] == ["a", "a", "b", "d", "c", None, "b"]


def test_program_spans_leave_the_harness_readers_alone():
    plain, spanned = trace.reduce(_events()), trace.reduce(_program_events())
    for t in (plain, spanned):
        t.units, t.host_units = 4.0, 2.0
    config = spec.load_cell("gan_su.train").config
    for t in (plain, spanned):
        assert t.idle_gaps == plain.idle_gaps
    runs = [types.SimpleNamespace(trace=t, config=config,
                                  window={"units": 100, "seconds": 4e-3})
            for t in (plain, spanned)]
    for reader in (readers.idle_pct, readers.untraced_idle_pct,
                   readers.launches_per_unit, readers.grouped_conv_roofline):
        assert reader(runs[0]) == reader(runs[1]), reader.__name__


def test_the_program_pass_takes_fewer_steps():
    run = types.SimpleNamespace(traffic={"trace_steps": 12, "x": 1},
                                stash={"one_step": None})
    short = phases._Steps(run, phases.TRACED_STEPS)
    assert short.traffic == {"trace_steps": 4, "x": 1}
    assert short.stash is run.stash and run.traffic["trace_steps"] == 12
    assert phases._Steps(run, 20).traffic["trace_steps"] == 12


def test_adamw_step_bound_from_the_reference():
    config = spec.load_cell("gan_su.train").config
    # 23,546,832 + 11,856,336 parameters, 28 bytes each at 3.35 TB/s.
    n = 23_546_832 + 11_856_336
    assert phases.adamw_step_bound_s(config) == pytest.approx(
        28 * n / 3.35e12)


def test_readers_by_hand():
    counters = {"gan/g_forward": (0.3, 12), "adamw": (0.06, 24),
                "gan/ema": (0.012, 12), "synth/batches": (70, 70),
                "synth/fetch": (0.4, 70), "synth/valid_frames": (878, 70),
                "synth/computed_frames": (1000, 70)}
    t = phases.ProgramTrace(1.0, 0.5, 12.0, [],
                            {"ste_gan/adamw": 12 * 0.6e-3}, {})
    run = types.SimpleNamespace(
        stash={"phases.untraced": {"units": 12.0, "seconds": 1.1,
                                   "counters": counters},
               "phases.traced": t},
        config=spec.load_cell("gan_su.train").config)
    assert phases.host_ms_per_unit(run, "gan/g_forward") == pytest.approx(25)
    assert phases.host_ms_per_unit(run, "adamw", "gan/ema") == pytest.approx(
        6.0)
    assert phases.host_ms_per_unit(run, "feed/wait") is None
    assert phases.padding_pct(run) == pytest.approx(12.2)
    assert phases.host_ms_per_batch(run) == pytest.approx(1e3 * 0.7 / 70)
    bound = phases.adamw_step_bound_s(run.config)
    assert phases.adamw_roofline(run) == pytest.approx(
        100 * bound / 0.6e-3)


def test_a_program_without_counters_gives_nothing(monkeypatch):
    monkeypatch.setattr(phases, "program_profiling", lambda: None)
    run = types.SimpleNamespace(stash={}, config={})
    for m in GAN_HOST + ("adamw_roofline.gan_train", "padding_pct.synth",
                         "host_ms_per_batch.synth"):
        assert spec.reader(m)(run) is None, m


def test_the_program_module_without_counters_is_not_read(monkeypatch):
    from ste_gan_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert phases.program_profiling() is None


def test_a_traced_gan_run_reads_its_phases():
    code, result, _ = execute("gan_su.train", 2 ** 31 + 7, trace=1,
                              f32=True)
    assert code == 0 and result["correct"]
    got = result["metrics"]
    for m in GAN_HOST:
        assert got[m]["value"] > 0, m
    # The CPU has no device operations for AdamW to be charged with.
    assert "adamw_roofline.gan_train" not in got


def test_a_traced_synthesis_run_reads_its_padding():
    code, result, _ = execute("gan_su.generate", 2 ** 31 + 9, trace=1)
    assert code == 0 and result["correct"]
    t = spec.load_cell("gan_su.generate").traffic
    t.update(tiny("gan_su.generate")["traffic"])
    lengths = sorted(common.lognormal_lengths(
        t["utterances"], t["median_frames"], t["sigma"], t["frames_min"],
        t["frames_max"]))
    bucket = t["bucket"]
    groups = {}
    for n in lengths:
        groups.setdefault(-(-n // bucket) * bucket, []).append(n)
    computed = sum(padded * len(g) for padded, g in groups.items())
    assert result["metrics"]["padding_pct.synth"]["value"] == pytest.approx(
        100 * (1 - sum(lengths) / computed))
    assert result["metrics"]["host_ms_per_batch.synth"]["value"] > 0
