"""The LFM2 encoder cell's pieces on the CPU at a narrow size: its driver
(a whole run, untraced and traced, and the faults its numbers catch), its
seeded weight maker and router balancing, the FLOP count and the five
readers against numbers worked out by hand. The products run in f32 here
(``models/lfm2.py``'s ``COMPUTE_DTYPE`` patched, the stated precision
overridden to match)."""
import types

import pytest
import torch

from portbench import lfm2_phases, peaks, readers, spec
from portbench.drivers import enc_train_lfm2 as drv

CELL = "enc_lfm2.train_mixed"
#: Narrow widths; the published layer pattern, GQA and 8 experts top-4.
TINY = {
    "config": {"hidden_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 2, "intermediate_size": 96,
               "moe_intermediate_size": 32, "num_experts": 8,
               "program": {"emg_encoder": {"params": {"model_size": 32}}},
               "control": {"stated": {"products": {"dtype": "float32"}}}},
    "traffic": {"corpus_utterances": 40, "frames_min": 20, "frames_max": 40,
                "max_len": 3200, "trace_steps": 2}}


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    from ste_gan_torch.models import lfm2

    monkeypatch.setattr(lfm2, "COMPUTE_DTYPE", torch.float32)


def _execute(seed: int, trace: int):
    from portbench import run

    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "0.5", "--trace", str(trace)])
    return run.execute(args, overrides=TINY, device="cpu")


def test_whole_run_is_correct_with_its_numbers():
    code, result, lines = _execute(2718281828459, 0)
    assert code == 0 and result["correct"]
    assert set(result["metrics"]) == {"enc_train_samples_per_s", "setup_s"}
    assert set(result["checks"]) == {"loss_gap", "grad_gap.enc",
                                     "change_gap", "bn_var_gap", "out_gap",
                                     "moe_out_gap", "pick_gap", "bias_gap"}
    assert result["checks"]["pick_gap"]["value"] == 0.0
    assert result["checks"]["bias_gap"]["value"] == 0.0
    assert len(lines) == 8


def _bias_frozen(monkeypatch):
    from ste_gan_torch.models.moe import DroplessMoE

    monkeypatch.setattr(DroplessMoE, "update_bias", lambda self: None)


def _bias_ignored(monkeypatch):
    from ste_gan_torch.models.moe import DroplessMoE

    real = DroplessMoE.route

    def route(self, tokens):
        bias, self.expert_bias = self.expert_bias, None
        try:
            return real(self, tokens)
        finally:
            self.expert_bias = bias
    monkeypatch.setattr(DroplessMoE, "route", route)


def _experts_fp8(monkeypatch):
    """Each grouped product's operands rounded to float8 e4m3, one scale
    a tensor (the precision below the stated one)."""
    from ste_gan_torch.models import moe

    real = moe.grouped_mm

    def fp8(t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale)

    monkeypatch.setattr(moe, "grouped_mm",
                        lambda a, b, ends: real(fp8(a), fp8(b), ends))


def _state_unchanged(monkeypatch):
    from ste_gan_torch.train import encoder as tenc

    real = tenc.make_encoder_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)

        def frozen(state, batch):
            saved = [p.detach().clone() for p in model.parameters()]
            state, metrics = step(state, batch)
            with torch.no_grad():
                for p, q in zip(model.parameters(), saved):
                    p.copy_(q)
            return state, metrics
        return frozen

    monkeypatch.setattr(tenc, "make_encoder_train_step", make)


@pytest.mark.parametrize("fault, number", [
    (_bias_frozen, "bias_gap"), (_state_unchanged, "change_gap"),
    (_bias_ignored, "pick_gap"), (_experts_fp8, "moe_out_gap")])
def test_a_fault_turns_correct_false(fault, number, monkeypatch):
    fault(monkeypatch)
    code, result, _ = _execute(1618033988749, 0)
    assert code == 0 and not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"]


def test_traced_run_reads_what_the_cpu_has():
    code, result, _ = _execute(31415926535, 1)
    assert code == 0 and result["correct"]
    got = result["metrics"]
    # No card: no device time under the spans, so the rooflines are left
    # out; the counters and the FLOPs are there.
    assert "moe_expert_roofline.enc_lfm2_train" not in got
    assert "short_conv_roofline.enc_lfm2_train" not in got
    assert 1.0 <= got["moe_load_imbalance.enc_lfm2_train"]["value"] <= 8.0
    assert got["mfu.enc_lfm2_train"]["value"] > 0


def test_weight_maker_draws_each_leaf_again_alike():
    cell = spec.load_cell(CELL, overrides=TINY)
    w = drv.Weights(cell.config, 5, torch.device("cpu"))
    name = "layers.4.feed_forward.w1"
    assert torch.equal(w.leaf(name), w.leaf(name))
    assert not torch.equal(w.leaf(name),
                           drv.Weights(cell.config, 6, "cpu").leaf(name))
    assert torch.equal(w.leaf("layers.0.operator_norm.weight"),
                       torch.ones(64))
    assert torch.equal(w.leaf("layers.4.feed_forward.expert_bias"),
                       torch.zeros(8))
    from ste_gan_torch.models.emg_encoder import init_emg_encoder

    with torch.device("meta"):
        program = init_emg_encoder(drv.program_config(cell.config))
    w.fill(program)
    reference = w.fill(drv.reference_module(cell.config))
    for key, value in program.state_dict().items():
        assert torch.equal(value, reference.state_dict()[key]), key
    big = program.layers[0].feed_forward.w1.weight
    assert float(big.detach().std()) == pytest.approx(drv.INIT_STD, rel=0.05)
    assert all(v == 0.0 for v in w.change_norms(program).values())


def test_balancing_loads_the_experts_evenly():
    """Scores with one large offset per expert send every token to the
    same experts; the balanced bias spreads the picks evenly."""
    g = torch.Generator().manual_seed(3)
    scores = torch.sigmoid(3.0 * torch.randn(32, generator=g)
                           + 0.3 * torch.randn(8000, 32, generator=g))

    def loads(bias):
        chosen = torch.topk(scores + bias, 4, dim=-1).indices
        return torch.bincount(chosen.reshape(-1), minlength=32).float()

    assert float(loads(torch.zeros(32)).max()) > 7000
    even = loads(drv.balanced_bias(scores, 4))
    assert float(even.max()) / float(even.mean()) < 1.05


def test_balanced_start_feeds_the_weight_maker():
    cell = spec.load_cell(CELL, overrides=TINY)
    emg = torch.tanh(0.4 * torch.randn(
        2, 1600, 8, generator=torch.Generator().manual_seed(4)))
    start = drv.balanced_start(cell.config, 5, "cpu", emg)
    assert sorted(start) == [f"layers.{i}.feed_forward.expert_bias"
                             for i in range(2, 8)] + ["w_raw_in.bias"]
    w = drv.Weights(cell.config, 5, "cpu", start)
    for name in start:
        assert torch.equal(w.leaf(name), start[name])
    assert float(start["layers.4.feed_forward.expert_bias"].abs().max()) > 0
    # The input projection's outputs are centred over the windows.
    drawn = drv.Weights(cell.config, 5, "cpu").leaf("w_raw_in.bias")
    assert not torch.equal(drawn, start["w_raw_in.bias"])


def test_flop_count_of_the_stated_model():
    from portbench import flops_lfm2

    cell = spec.load_cell(CELL)
    per_sample = flops_lfm2.enc_lfm2_sample(cell.config, cell.traffic)
    assert per_sample == pytest.approx(cell.config["flops"][
        "enc_lfm2_train_sample"])
    # Expert products alone: 6 layers, 8,000 frames, 4 picks, 3 products
    # forward and 6 backward of 2 D F.
    experts = 6 * 8000 * 4 * 9 * 2 * 2048 * 1792
    assert per_sample["bf16"] * 128000 > experts
    assert experts / (per_sample["bf16"] * 128000) == pytest.approx(
        0.554, abs=0.01)


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _events():
    """A 100 us window. The forward's ``enc/moe/experts`` span on thread 1
    (10-20) launches a 30 us kernel; the backward's on thread 2 (autograd,
    50-60) launches 10 us; a short-conv span on thread 2 (70-80) launches
    5 us; a launch outside every span 4 us."""
    return [
        _ev("portbench/window", "user_annotation", 0, 100),
        _ev("ste_gan/enc/forward", "user_annotation", 5, 30),
        _ev("ste_gan/enc/moe/experts", "user_annotation", 10, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        _ev("gemm", "kernel", 20, 30, tid=9, correlation=1),
        _ev("ste_gan/enc/moe/experts", "user_annotation", 50, 10, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 55, 1, tid=2,
            correlation=2),
        _ev("gemm", "kernel", 60, 10, tid=9, correlation=2),
        _ev("ste_gan/enc/lfm2/short_conv", "user_annotation", 70, 10,
            tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 72, 1, tid=2,
            correlation=3),
        _ev("mul", "kernel", 80, 5, tid=9, correlation=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 90, 1, correlation=4),
        _ev("copy", "kernel", 92, 4, tid=9, correlation=4),
    ]


def test_device_time_by_span_on_every_thread():
    got = lfm2_phases.by_span(_events())
    assert got["ste_gan/enc/moe/experts"] == pytest.approx(40e-6)
    assert got["ste_gan/enc/lfm2/short_conv"] == pytest.approx(5e-6)
    assert got["other"] == pytest.approx(4e-6)


def _run_with(traced=None, untraced=None):
    cell = spec.load_cell(CELL)
    run = types.SimpleNamespace(config=cell.config, traffic=cell.traffic,
                                cuda=True, stash={})
    run.stash["lfm2_phases.traced"] = traced
    run.stash["phases.untraced"] = untraced
    return run


def test_roofline_readers_by_hand():
    picks = 6 * 8000 * 4 * 2.0  # two steps
    run = _run_with(traced={"units": 2.0, "device_s": {
        lfm2_phases.EXPERTS: 0.05, lfm2_phases.SHORT_CONV: 0.004},
        "counters": {"moe/picks": (picks, 12)}})
    ops = 9 * 2 * picks * 2048 * 1792
    assert lfm2_phases.moe_expert_roofline(run) == pytest.approx(
        100 * ops / 989e12 / 0.05)
    nbytes = 22 * 2 * 8000 * 2048 * 6 * 2
    assert lfm2_phases.short_conv_roofline(run) == pytest.approx(
        100 * nbytes / peaks.HBM_BYTES_PER_S / 0.004)


def test_load_imbalance_reader_by_hand():
    run = _run_with(untraced={"units": 12, "seconds": 1.0, "counters": {
        "moe/picks": (32000.0 * 72, 72), "moe/max_load": (1500.0 * 72, 72)}})
    assert lfm2_phases.load_imbalance(run) == pytest.approx(1.5)


@pytest.mark.parametrize("reader", [
    "moe_expert_roofline.enc_lfm2_train",
    "short_conv_roofline.enc_lfm2_train",
    "moe_load_imbalance.enc_lfm2_train"])
def test_readers_give_nothing_without_the_programs_spans(reader):
    """The parent commit's program has neither the spans nor the
    counters: each reader gives None and the line leaves it out."""
    run = _run_with(traced={"units": 4.0, "device_s": {"other": 1.0},
                            "counters": {}},
                    untraced={"units": 12, "seconds": 1.0, "counters": {}})
    assert spec.reader(reader)(run) is None
    assert spec.reader(reader)(_run_with()) is None


def test_mfu_and_idle_readers():
    cell = spec.load_cell(CELL)
    run = types.SimpleNamespace(config=cell.config,
                                window={"units": 1.28e6, "seconds": 1.0},
                                trace=None)
    least = peaks.least_seconds(cell.config["flops"][
        "enc_lfm2_train_sample"]) * 1.28e6
    assert spec.reader("mfu.enc_lfm2_train")(run) == pytest.approx(
        100 * least)
    assert readers.idle_pct(run) is None
    assert spec.reader("device_idle_pct.enc_lfm2_train")(run) is None
