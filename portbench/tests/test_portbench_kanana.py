"""The kanana encoder cell's pieces on the CPU at a narrow size: its driver
(a whole run, untraced and traced, and the faults its numbers catch), its
weight maker, the published keys it checks, the control's stand-ins, the
FLOP count and the readers against numbers worked out by hand. The
products run in f32 here (``models/lfm2.py``'s ``COMPUTE_DTYPE`` patched,
the stated precision overridden to match)."""
import types

import pytest
import torch

from portbench import kanana_phases, lfm2_phases, peaks, spec
from portbench.drivers import enc_train_kanana as drv
from portbench.drivers.enc_train_lfm2 import INIT_STD

CELL = "enc_kanana.train_mixed"
#: Narrow widths; the leading dense layer, 4 sparse layers, unequal
#: query/key and value heads, 16 experts top-6 and the shared expert.
TINY = {
    "config": {"hidden_size": 64, "num_attention_heads": 4,
               "kv_lora_rank": 16, "qk_nope_head_dim": 8,
               "qk_rope_head_dim": 8, "v_head_dim": 12,
               "intermediate_size": 96, "moe_intermediate_size": 16,
               "n_routed_experts": 16,
               "program": {"emg_encoder": {"params": {"model_size": 32}}},
               "control": {"stated": {"products": {"dtype": "float32"}}}},
    "traffic": {"corpus_utterances": 40, "frames_min": 20, "frames_max": 40,
                "max_len": 3200, "trace_steps": 2}}


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    from ste_gan_torch.models import lfm2

    monkeypatch.setattr(lfm2, "COMPUTE_DTYPE", torch.float32)


def _execute(seed: int, trace: int, overrides=TINY):
    from portbench import run

    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "0.5", "--trace", str(trace)])
    return run.execute(args, overrides=overrides, device="cpu")


def test_whole_run_is_correct_with_its_numbers():
    code, result, lines = _execute(2718281828459, 0)
    assert code == 0 and result["correct"]
    assert set(result["metrics"]) == {"enc_train_samples_per_s", "setup_s"}
    assert set(result["checks"]) == {"loss_gap", "grad_gap.enc",
                                     "change_gap", "bn_var_gap", "out_gap",
                                     "moe_out_gap", "pick_gap", "bias_gap",
                                     "mla_out_gap"}
    assert result["checks"]["pick_gap"]["value"] == 0.0
    assert result["checks"]["mla_out_gap"]["value"] < 1e-5
    assert len(lines) == 9


def _rope_not_interleaved(monkeypatch):
    from ste_gan_torch.models import deepseek_v3, lfm2

    monkeypatch.setattr(deepseek_v3, "interleaved_rope", lfm2.rope)


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


#: The hidden width and the rotary width that make RoPE matter: at 64
#: wide, N(0, 0.02) projections give logits near 0, so attention is
#: nearly even whatever the positions (the published 2,048 and 64 give
#: logits of order 1).
WIDE = {"config": dict(TINY["config"], hidden_size=1024,
                       qk_rope_head_dim=32), "traffic": TINY["traffic"]}


@pytest.mark.parametrize("fault, number, overrides", [
    (_rope_not_interleaved, "mla_out_gap", WIDE),
    (_experts_fp8, "moe_out_gap", TINY)])
def test_a_fault_turns_correct_false(fault, number, overrides, monkeypatch):
    fault(monkeypatch)
    code, result, _ = _execute(1618033988749, 0, overrides)
    assert code == 0 and not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"]


def test_traced_run_reads_what_the_cpu_has():
    code, result, _ = _execute(31415926535, 1)
    assert code == 0 and result["correct"]
    got = result["metrics"]
    # No card: no device time under the spans, so the rooflines are left
    # out; the counters and the FLOPs are there.
    assert "mla_roofline.enc_kanana_train" not in got
    assert "moe_expert_roofline.enc_kanana_train" not in got
    assert 1.0 <= got["moe_load_imbalance.enc_kanana_train"]["value"] <= 16.0
    assert got["mfu.enc_kanana_train"]["value"] > 0


def test_weight_maker_fills_program_and_reference_alike():
    cell = spec.load_cell(CELL, overrides=TINY)
    w = drv.Weights(cell.config, 5, torch.device("cpu"))
    assert torch.equal(w.leaf("layers.2.self_attn.kv_a_layernorm.weight"),
                       torch.ones(16))
    assert torch.equal(w.leaf("layers.2.mlp.expert_bias"), torch.zeros(16))
    from ste_gan_torch.models.emg_encoder import init_emg_encoder

    with torch.device("meta"):
        program = init_emg_encoder(drv.program_config(cell.config))
    w.fill(program)
    reference = w.fill(drv.reference_module(cell.config))
    for key, value in program.state_dict().items():
        assert torch.equal(value, reference.state_dict()[key]), key
    big = program.layers[3].mlp.w1
    assert float(big.detach().std()) == pytest.approx(INIT_STD, rel=0.05)
    assert all(v == 0.0 for v in w.change_norms(program).values())


@pytest.mark.parametrize("key, value", [
    ("q_lora_rank", 1536), ("n_group", 8), ("scoring_func", "softmax"),
    ("rope_interleave", False), ("rope_scaling", {"type": "yarn"})])
def test_unwritten_published_choices_are_refused(key, value):
    cell = spec.load_cell(CELL, overrides={"config": {key: value}})
    with pytest.raises(ValueError, match=key):
        drv.encoder_params(cell.config)


def test_control_stand_ins_from_the_config_file():
    from portbench import control_kanana
    from portbench.control import precision

    cell = spec.load_cell(CELL)
    base = drv.stated(cell.config)
    entries = cell.config["control"]
    prec, variant = control_kanana.stand_in(entries["fp8_products"], base)
    assert prec.mm().fp8 and prec.tf32
    assert variant == control_kanana.ref_kanana.PUBLISHED
    prec, variant = control_kanana.stand_in(entries["rope_not_interleaved"],
                                            base)
    assert prec == base and not variant.rope_interleave
    _, variant = control_kanana.stand_in(entries["latent_norm_left_out"], base)
    assert not variant.latent_norm and variant.rope_interleave
    _, variant = control_kanana.stand_in(entries["fp8_experts"], base)
    assert variant.experts == precision(entries["fp8_experts"]["experts"])


def test_flop_count_of_the_stated_model():
    from portbench import flops_kanana

    cell = spec.load_cell(CELL)
    per_sample = flops_kanana.enc_kanana_sample(cell.config, cell.traffic)
    assert per_sample == pytest.approx(cell.config["flops"][
        "enc_kanana_train_sample"])
    # Routed expert products alone: 4 layers, 8,000 frames, 6 picks, 3
    # products forward and 6 backward of 2 D F.
    experts = 4 * 8000 * 6 * 9 * 2 * 2048 * 768
    assert experts / (per_sample["bf16"] * 128000) == pytest.approx(
        0.345, abs=0.005)


def _run_with(traced=None, untraced=None):
    cell = spec.load_cell(CELL)
    run = types.SimpleNamespace(config=cell.config, traffic=cell.traffic,
                                cuda=True, stash={})
    run.stash["lfm2_phases.traced"] = traced
    run.stash["phases.untraced"] = untraced
    return run


def test_mla_work_by_hand():
    ops, nbytes = kanana_phases.mla_work(
        drv.encoder_params(spec.load_cell(CELL).config), 80, 100)
    # 5 layers, 80 windows, 32 heads, 5,050 causal pairs, 3 products of
    # 192 and 3 of 128.
    assert ops == 5 * 2.0 * 80 * 32 * 5050 * (3 * 192 + 3 * 128)
    per_frame = (5 * 512 + (6144 + 8192 + 64 + 4096)
                 + (4096 + 6144 + 8192 + 64 + 4096) + (6144 + 8192 + 64))
    assert nbytes == 5 * 2.0 * 8000 * per_frame


def test_roofline_readers_by_hand():
    picks = 4 * 8000 * 6 * 2.0  # two steps
    run = _run_with(traced={"units": 2.0, "device_s": {
        lfm2_phases.EXPERTS: 0.05, kanana_phases.MLA_ATTENTION: 0.02},
        "counters": {"moe/picks": (picks, 8)}})
    ops = 9 * 2 * picks * 2048 * 768
    assert kanana_phases.moe_expert_roofline(run) == pytest.approx(
        100 * ops / 989e12 / 0.05)
    _, nbytes = kanana_phases.mla_work(drv.encoder_params(run.config), 80,
                                       100)
    assert kanana_phases.mla_roofline(run) == pytest.approx(
        100 * 2 * nbytes / peaks.HBM_BYTES_PER_S / 0.02)


def test_load_imbalance_reader_by_hand():
    run = _run_with(untraced={"units": 12, "seconds": 1.0, "counters": {
        "moe/picks": (48000.0 * 48, 48), "moe/max_load": (750.0 * 48, 48)}})
    assert kanana_phases.load_imbalance(run) == pytest.approx(2.0)


@pytest.mark.parametrize("reader", [
    "mla_roofline.enc_kanana_train",
    "moe_expert_roofline.enc_kanana_train",
    "moe_load_imbalance.enc_kanana_train"])
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
        "enc_kanana_train_sample"]) * 1.28e6
    assert spec.reader("mfu.enc_kanana_train")(run) == pytest.approx(
        100 * least)
    assert spec.reader("device_idle_pct.enc_kanana_train")(run) is None


def test_control_reads_every_stand_in():
    """Each stand-in of the config file's ``control`` runs through the
    reference's check steps and block numbers (a stand-in that leaves a
    parameter out of the graph would stop the readings)."""
    from portbench import control_kanana

    cell = spec.load_cell(CELL, overrides=TINY)
    got = dict(control_kanana.one_seed(cell, 141421356, False, "cpu"))
    assert set(got) == {"program", "stated", "half_batch"} | (
        set(cell.config["control"]) - {"stated"})
    assert got["program"]["mla_out_gap"] < 1e-5
    assert got["fp8_products"]["mla_out_gap"] > 1e-3
    assert got["latent_norm_left_out"]["mla_out_gap"] > 1e-2
