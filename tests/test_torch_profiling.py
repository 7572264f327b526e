"""The port's spans and counters (``ste_gan_torch/utils/profiling.py``): the
off path makes no torch call, the on path nests ``ste_gan/`` ranges in a
profiler trace as the calls do, and the GAN step, the encoder step, the
data feed and ``convert_dataset`` open every span and counter they name,
on the CPU at tiny sizes."""
import sys
import threading

import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.config import Config
from ste_gan_torch.data.device_corpus import DeviceCorpus
from ste_gan_torch.data.loader import Prefetcher
from ste_gan_torch.generate_emg import pass_readout
from ste_gan_torch.infer import EMGSynthesizer, convert_dataset
from ste_gan_torch.models.discriminator import DiscriminatorEnsemble
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_torch.ops.fused_adamw import set_learning_rate
from ste_gan_torch.train import encoder as tenc
from ste_gan_torch.train import encoder_data as tdata
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.utils import profiling

GAN_SPANS = ("gan/g_forward", "gan/d_update", "gan/g_update",
             "gan/g_loss/d_forward", "gan/g_loss/multi_td",
             "gan/g_loss/encoder", "gan/g_loss/feature_matching",
             "gan/g_backward", "adamw", "gan/ema")
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with the spans' profiler ranges off."""
    previous = profiling.tracing(False)
    yield
    profiling.tracing(previous)


def _program_events(prof):
    return [e for e in prof.events() if e.name.startswith(profiling.PREFIX)]


def test_off_path_makes_no_torch_call(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span called torch with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("test/off"):
        pass
    before = profiling.counters()
    with profiling.span("test/off"):
        pass
    assert profiling.since(before)["test/off"][1] == 1


def test_off_path_leaves_no_range_in_a_trace():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("test/outer"):
            torch.ones(4).sum()
    assert _program_events(prof) == []


def test_on_path_ranges_nest_as_the_calls_do():
    profiling.tracing(True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("test/outer"):
            torch.ones(4).sum()
            with profiling.span("test/inner"):
                torch.ones(4).sum()
    by_name = {e.name: e for e in _program_events(prof)}
    assert set(by_name) == {"ste_gan/test/outer", "ste_gan/test/inner"}
    outer = by_name["ste_gan/test/outer"].time_range
    inner = by_name["ste_gan/test/inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end


def test_tracing_returns_the_previous_setting():
    assert profiling.tracing(True) is False
    assert profiling.tracing(False) is True


def test_counters_since_and_reset():
    before = profiling.counters()
    profiling.add("test/count", 3)
    profiling.add("test/count", 4.5)
    with profiling.span("test/timed"):
        pass
    got = profiling.since(before)
    assert got["test/count"] == (7.5, 2)
    assert got["test/timed"][1] == 1 and got["test/timed"][0] >= 0.0
    assert profiling.since(profiling.counters()) == {}
    profiling.reset()
    assert profiling.counters() == {}


def test_threads_lose_no_update():
    threads, each = 16, 2000
    before = profiling.counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                profiling.add("test/shared", 1)
                with profiling.span("test/shared_span"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.since(before)
    assert got["test/shared"] == (threads * each, threads * each)
    assert got["test/shared_span"][1] == threads * each


def test_step_timer_reports_host_ms_per_span(monkeypatch):
    clock = iter([10.0, 11.0])
    timer = profiling.StepTimer(channel_samples_per_step=100)
    profiling.add("test/phase", 0.25)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    assert timer.update(0) == {}
    profiling.add("test/phase", 0.5)
    out = timer.update(5)
    # 0.5 s of the phase over 5 steps in the window: 100 ms a step; what
    # came before the first boundary is not counted.
    assert out["perf/host_ms/test/phase"] == pytest.approx(100.0)
    assert out["perf/ms_per_step"] == pytest.approx(200.0)


def _tiny_gan(accum: int):
    cfg = Config()
    cfg.train.chunk_size = 256
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.train.grad_accum = accum
    cfg.model.params = {"channels": 32}
    cfg.data.num_emg_sessions = 4
    torch.manual_seed(0)
    models = tgan.GANModels(
        EMGGeneratorGanTTS(num_sessions=4, channels=32),
        DiscriminatorEnsemble(
            num_multi_pool=2, num_multi_scale=2,
            period_spec_override=((8, 3, 1, 2), (16, 3, 3, 2)),
            scale_spec_override=((8, 15, 1, 1, 7), (16, 9, 2, 4, 4),
                                 (32, 5, 1, 1, 2))),
        EMGEncoderTransformer(**ENC_KW))
    models.encoder.eval().requires_grad_(False)
    return cfg, models


@pytest.mark.parametrize("accum", [1, 2])
def test_gan_step_opens_every_span(accum):
    cfg, models = _tiny_gan(accum)
    state = tgan.init_state(cfg, models)
    step = tgan.make_train_step(cfg, models)
    batch = tgan.synthetic_batch(cfg, "cpu", seed=3)
    before = profiling.counters()
    step(state, batch)
    got = profiling.since(before)
    assert set(GAN_SPANS) <= set(got)
    # Two AdamW updates and one EMA a step; the forwards and the G phase
    # once per microbatch.
    assert got["adamw"][1] == 2 and got["gan/ema"][1] == 1
    assert got["gan/g_update"][1] == accum
    assert got["gan/g_forward"][1] == 2 * accum - (accum == 1)


def _enc_items(seed):
    """Two voiced utterances and two silent ones whose targets have other
    lengths."""
    rng = np.random.default_rng(seed)

    def item(pred_frames, target_frames, silent):
        return {
            C.DataType.REAL_EMG: np.tanh(rng.normal(
                0, 0.5, (pred_frames * 16, 8))).astype(np.float32),
            C.DataType.SPEECH_UNITS: rng.normal(
                size=(target_frames, 256)).astype(np.float32),
            C.DataType.PHONEMES: rng.integers(
                0, 48, target_frames).astype(np.int32),
            C.DataType.SPEAKING_MODE_ID: (C.SpeakingMode.SILENT if silent
                                          else C.SpeakingMode.NORMAL),
        }

    return [item(50, 50, False), item(60, 45, True), item(30, 30, False),
            item(40, 55, True)]


def test_encoder_fold_and_step_open_every_span():
    torch.manual_seed(0)
    items = _enc_items(5)
    corpus = tdata.EncoderDeviceCorpus(items, float_dtype=torch.float32,
                                       device="cpu")
    model = EMGEncoderTransformer(**ENC_KW)
    state = tenc.init_train_state(model)
    step = tenc.make_encoder_train_step(model, 8, silent_pred_frames=70)
    set_learning_rate(state.opt, 1e-4)
    rows = torch.tensor([0, 1, 2, 3, 0, 0, 0, 0], dtype=torch.int32)
    before = profiling.counters()
    batch = corpus.fold(rows, torch.tensor(4), n_win=2, max_samples=8,
                        max_silent=3, silent_target_frames=64)
    step(state, batch)
    got = profiling.since(before)
    assert set(got) >= {"enc/fold", "enc/forward", "enc/loss", "dtw",
                        "enc/backward", "adamw"}
    assert all(got[name][1] == 1 for name in got)


def test_feed_spans_wait_and_gather():
    n, frames, hop = 3, 8, 16
    corpus = DeviceCorpus(
        emg=torch.zeros((n, frames * hop, 8)),
        speech_units=torch.zeros((n, frames, 256)),
        phonemes=torch.zeros((n, frames), dtype=torch.int32), mfccs=None,
        session_index=torch.zeros((n,), dtype=torch.int32),
        speaking_mode_index=torch.zeros((n,), dtype=torch.int32),
        emg_train_length=4 * hop, hopsize=hop, unit_lengths=[frames] * n)
    descriptors = [{"rows": torch.tensor([0, 2]),
                    "starts": torch.tensor([1, 4])}] * 3
    before = profiling.counters()
    for d in Prefetcher(lambda: iter(descriptors)):
        corpus.gather(d["rows"], d["starts"])
    got = profiling.since(before)
    assert got["feed/gather"][1] == 3
    # One wait per item and one for the end of the stream.
    assert got["feed/wait"][1] == 4


def test_convert_dataset_counters_match_a_count_by_hand():
    torch.manual_seed(0)
    synth = EMGSynthesizer(EMGGeneratorGanTTS(num_sessions=4, channels=32),
                           device="cpu")
    rng = np.random.default_rng(0)
    lengths = [65, 5, 30, 64, 17, 33]
    split = [{C.DataType.UTT_ID: f"u{i}", C.DataType.SESSION_ID: "s0",
              C.DataType.SESSION_INDEX: i % 4,
              C.DataType.SPEAKING_MODE_INDEX: 0,
              C.DataType.SPEECH_UNITS: rng.normal(size=(n, 256)).astype(
                  np.float32)} for i, n in enumerate(lengths)]
    before = profiling.counters()
    out = convert_dataset(synth, split, bucket=16, max_batch=2)
    got = profiling.since(before)
    assert [len(r[C.DataType.FAKE_EMG]) for r in out] == [
        16 * n for n in lengths]
    # Padded lengths 80, 16, 32, 64, 32, 48: batches [5] at 16, [17, 30]
    # at 32, [33] at 48, [64] at 64, [65] at 80.
    assert got["synth/batches"] == (5, 5)
    assert got["synth/valid_frames"][0] == sum(lengths)
    assert got["synth/computed_frames"][0] == 16 + 2 * 32 + 48 + 64 + 80
    for name in ("synth/pack", "synth/h2d", "synth/forward", "synth/fetch",
                 "synth/unpack"):
        assert got[name][1] == 5, name
    padding, host_ms = pass_readout(got, 2.0)
    assert padding == pytest.approx(100.0 * (1.0 - 214 / 272))
    assert host_ms == pytest.approx(1e3 * (2.0 - got["synth/fetch"][0]) / 5)


def test_pass_readout_of_an_empty_pass():
    padding, host_ms = pass_readout({}, 1.0)
    assert np.isnan(padding) and np.isnan(host_ms)
