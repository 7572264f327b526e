"""The port's DeepSeek-V3 encoder (``EMGEncoderDeepseekV3``: kanana-2-30b-a3b's
block stack behind the published encoder's front end) against the plain
reference ``portbench/reference/kanana.py``, f32 on the CPU at narrow
widths that keep every part: the leading dense layer and two sparse ones,
multi-head latent attention with unequal query/key and value heads, 16
experts top-6 and a shared expert of two experts' width.

The products run in f32 here (``models/lfm2.py``'s ``COMPUTE_DTYPE``
patched by the ``f32`` fixture); the shipped type runs them in bf16.
Tolerances: f32 against f32, so only the order of sums differs (1e-5
relative on outputs, 1e-4 of a leaf's norm on gradients); the DroplessMoE
without a shared expert is held bit for bit to the block as it was.

* MLA alone: interleaved RoPE, the one ``k_pe`` every head shares, the
  unequal widths; forward and gradients.
* ``DroplessMoE`` with a shared expert: output, picks, gates, counters,
  span and bias update; and without one, exactly the block as it was.
* The whole encoder: forward, loss, gradients and the first bias update;
  three steps of the benchmark cell's own path against the reference.
* Causality, the shipped yaml at the published widths, the trainer CLI,
  export and quant refusing the type, the one-device rule.

On the card (marked ``card``; they skip without one): MLA at the
published widths in bf16 against the reference at the stated precision,
and the shared-expert block under CUDA's sync debug mode.
"""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from portbench.drivers import enc_train_kanana as drv
from portbench.reference import kanana as ref
from portbench.reference import nets
from portbench.reference.precision import Precision
from ste_gan_torch.config import load_config
from ste_gan_torch.models import deepseek_v3, lfm2, moe
from ste_gan_torch.models.emg_encoder import (EMGEncoderDeepseekV3,
                                              init_emg_encoder)
from ste_gan_torch.utils import profiling

#: Narrow widths; every part of the published block kept.
TINY = dict(model_size=32, num_extra_res_blocks=3, hidden_size=64,
            num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=12,
            intermediate_size=96, moe_intermediate_size=16,
            first_k_dense_replace=1, n_routed_experts=16,
            num_experts_per_tok=6, n_shared_experts=2,
            routed_scaling_factor=2.448, rms_norm_eps=1e-6, rope_theta=1e4)


@pytest.fixture
def f32(monkeypatch):
    """The encoder's products in f32, as the f32 reference's."""
    monkeypatch.setattr(lfm2, "COMPUTE_DTYPE", torch.float32)


def _pair(seed: int = 0):
    """The port's encoder (seeded init, weights widened to 0.2 so that
    attention and routing are far from uniform, expert biases spread) and
    the reference with its weights, f32."""
    g = torch.Generator().manual_seed(seed)
    port = EMGEncoderDeepseekV3(**TINY, generator=g)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.startswith("layers.") and p.dim() >= 2:
                p.normal_(0.0, 0.2, generator=g)
        for layer in port.layers[1:]:
            layer.mlp.expert_bias.copy_(0.05 * torch.randn(16, generator=g))
    reference = ref.KananaEncoder(**ref.config_sizes(TINY))
    reference.load_state_dict(port.state_dict(), strict=True)
    return port, reference


def _emg(seed: int, windows: int = 3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.tanh(rng.normal(0, 0.5, (windows, 1600, 8))
                                    ).astype(np.float32))


def _grads_close(names, grads, grads_r):
    largest = max(float(g.norm()) for g in grads_r)
    for name, g, g_r in zip(names, grads, grads_r):
        assert float((g - g_r).norm()) <= (1e-4 * float(g_r.norm())
                                           + 1e-6 * largest), name


def test_mla_matches_the_reference(f32):
    port, reference = _pair(1)
    mla, mla_r = port.layers[1].self_attn, reference.layers[1].self_attn
    # One rotary key a frame, shared by the heads; heads of 8 + 8 and 12.
    assert tuple(mla.kv_a_proj_with_mqa.weight.shape) == (16 + 8, 64)
    assert tuple(mla.kv_b_proj.weight.shape) == (4 * (8 + 12), 16)
    assert tuple(mla.o_proj.weight.shape) == (64, 4 * 12)
    x = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    y = mla(x)
    with ref.F32.active():
        y_r = mla_r(x, ref.F32)
    torch.testing.assert_close(y, y_r, rtol=1e-5, atol=1e-6)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    names = [n for n, _ in mla.named_parameters()]
    params_r = dict(mla_r.named_parameters())
    got = torch.autograd.grad(y, [x, *mla.parameters()], dy)
    want = torch.autograd.grad(y_r, [x, *(params_r[n] for n in names)], dy)
    _grads_close(["x", *names], got, want)
    # Each stand-in the controls use moves the output well past rounding.
    for variant in (ref.Variant(rope_interleave=False),
                    ref.Variant(latent_norm=False)):
        with torch.no_grad():
            other = mla_r(x, ref.F32, variant)
            assert float((other - y_r).norm() / y_r.norm()) > 1e-2, variant


def test_interleaved_rope_is_the_pairwise_rotation():
    """The port's form (transformers': reorder, then the half split) is
    the reference's pairwise rotation with its output de-interleaved, so
    every dot product of two rotated vectors agrees; it is not the half
    split on the raw vector."""
    g = torch.Generator().manual_seed(4)
    q, k = torch.randn(2, 3, 10, 8, generator=g), torch.randn(
        2, 3, 10, 8, generator=g)
    port_q, port_k = (deepseek_v3.interleaved_rope(t, 1e4) for t in (q, k))
    ref_q, ref_k = (ref.rotate(t, 1e4) for t in (q, k))
    order = list(range(0, 8, 2)) + list(range(1, 8, 2))
    torch.testing.assert_close(port_q, ref_q[..., order])
    torch.testing.assert_close(port_q @ port_k.transpose(-1, -2),
                               ref_q @ ref_k.transpose(-1, -2))
    assert not torch.allclose(lfm2.rope(q, 1e4), port_q, atol=1e-3)
    # Position 0 is not turned.
    torch.testing.assert_close(port_q[..., 0, :], q[..., 0, order])


def test_shared_expert_block_matches_the_reference(f32):
    port, reference = _pair(5)
    block, block_r = port.layers[2].mlp, reference.layers[2].mlp
    tokens = torch.randn(300, 64, generator=torch.Generator().manual_seed(6))
    chosen, gates = block.route(tokens)
    before = profiling.counters()
    out = block(tokens.view(3, 100, 64), train=True)
    added = profiling.since(before)
    out_r = block_r(tokens.view(3, 100, 64), ref.F32)
    torch.testing.assert_close(out, out_r, rtol=1e-5, atol=1e-5)
    scores = torch.sigmoid(tokens @ block_r.gate.weight.T)
    want = torch.topk(scores + block_r.expert_bias, 6).indices
    assert torch.equal(chosen.sort(dim=1).values, want.sort(dim=1).values)
    assert torch.allclose(gates.sum(dim=1), torch.full((300,), 2.448),
                          atol=1e-5)
    assert block.gate_eps == 1e-20
    assert torch.equal(block.load, block_r.load.to(torch.int64))
    assert added["moe/picks"][0] == 1800
    assert added["enc/moe/shared"][1] == 1
    # The shared expert is the part every token gets.
    shared = block.shared_experts(tokens)
    torch.testing.assert_close(shared, block_r.shared_experts(tokens,
                                                              ref.F32))
    bias = block.expert_bias.clone()
    block.update_bias()
    block_r.update_bias()
    torch.testing.assert_close(block.expert_bias, block_r.expert_bias)
    assert not torch.equal(bias, block.expert_bias)


def _block_as_it_was(block, x):
    """``DroplessMoE.forward`` before the shared expert and the gates'
    normaliser were added, written out."""
    b, t, d = x.shape
    s, k, dt = b * t, block.top_k, block.dtype
    tokens = x.reshape(s, d)
    scores = torch.sigmoid(tokens.float() @ block.gate.weight.float().T)
    choice = scores.detach() + block.expert_bias
    chosen = torch.topk(choice, k, dim=-1).indices
    gates = scores.gather(1, chosen)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-6)
    gates = gates * block.routed_scaling_factor
    flat = chosen.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(block.num_experts, dtype=torch.int64).scatter_add_(
        0, flat, torch.ones_like(flat))
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    xs = tokens.to(dt).index_select(0, order // k)
    ys = moe.grouped_swiglu(xs, block.w1.to(dt), block.w3.to(dt),
                            block.w2.to(dt), ends)
    back = torch.empty_like(order)
    back[order] = torch.arange(s * k)
    y = (ys.index_select(0, back).view(s, k, d).float()
         * gates[..., None]).sum(dim=1)
    return y.reshape(b, t, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_without_a_shared_expert_is_as_it_was(dtype):
    block = moe.DroplessMoE(32, 8, 24, 4, True, 1.0, True, dtype,
                            torch.Generator().manual_seed(7))
    with torch.no_grad():
        block.expert_bias.copy_(torch.linspace(-0.01, 0.01, 8))
    assert block.shared_experts is None and block.gate_eps == 1e-6
    x = torch.randn(2, 50, 32, generator=torch.Generator().manual_seed(8),
                    requires_grad=True)
    before = profiling.counters()
    y = block(x, train=True)
    assert "enc/moe/shared" not in profiling.since(before)
    y_was = _block_as_it_was(block, x)
    assert torch.equal(y, y_was)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
    leaves = [x, block.gate.weight, block.w1, block.w3, block.w2]
    for a, b in zip(torch.autograd.grad(y, leaves, dy),
                    torch.autograd.grad(y_was, leaves, dy)):
        assert torch.equal(a, b)


def test_forward_loss_gradients_and_bias_update_match_the_reference(f32):
    port, reference = _pair(10)
    x = _emg(11)
    r1 = torch.randn(3, 100, nets.UNIT_DIM,
                     generator=torch.Generator().manual_seed(12))
    r2 = torch.randn(3, 100, nets.PHONEMES,
                     generator=torch.Generator().manual_seed(13))
    su, ph = port(x, train=True, shift=5)
    with ref.F32.active():
        su_r, ph_r = reference(x, train=True, shift=5)
    torch.testing.assert_close(su, su_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ph, ph_r, rtol=1e-4, atol=1e-5)
    loss = (su * r1).sum() + (ph * r2).sum()
    loss_r = (su_r * r1).sum() + (ph_r * r2).sum()
    assert float(loss.detach()) == pytest.approx(float(loss_r.detach()),
                                                rel=1e-5)
    names = [n for n, _ in port.named_parameters()]
    params_r = dict(reference.named_parameters())
    _grads_close(names, torch.autograd.grad(loss, list(port.parameters())),
                 torch.autograd.grad(loss_r, [params_r[n] for n in names]))
    buffers_r = dict(reference.named_buffers())
    for name, b in port.named_buffers():
        torch.testing.assert_close(b.float(), buffers_r[name].float(),
                                   rtol=1e-5, atol=1e-6, msg=name)
    port.update_expert_bias()
    for block in reference.sparse():
        block.update_bias()
    for name, b in port.named_buffers():
        if name.endswith("expert_bias"):
            torch.testing.assert_close(b, buffers_r[name], msg=name)


def _cell_numbers(seed: int):
    """The benchmark cell's driver at the narrow widths, on the CPU: its
    set-up (the check steps on the trainer's path), a short window, and
    the numbers against the reference's steps."""
    from portbench import spec
    from portbench.run import Run

    over = {"config": {k: TINY[k] for k in drv.ARCH_KEYS if k in TINY},
            "traffic": {"corpus_utterances": 40, "frames_min": 20,
                        "frames_max": 40, "max_len": 3200,
                        "trace_steps": 2}}
    over["config"]["program"] = {"emg_encoder": {"params": {
        "model_size": 32}}}
    # The blocks are held to the reference's at the stated precision:
    # f32 here, as the program's products.
    over["config"]["control"] = {"stated": {"products": {
        "dtype": "float32"}}}
    cell = spec.load_cell("enc_kanana.train_mixed", overrides=over)
    run = Run(cell, seed, 0.3, torch.device("cpu"))
    drv.setup(run)
    rate = drv.window(run)["enc_train_samples_per_s"]
    drv.release(run)
    checks = {name: (value, limit) for name, value, limit in drv.check(run)}
    return checks, rate


@pytest.mark.parametrize("seed", [2718281828459, 31415926])
def test_three_train_steps_with_bias_updates_match_the_reference(seed, f32):
    checks, rate = _cell_numbers(seed)
    assert all(value <= limit for value, limit in checks.values()), checks
    assert checks["loss_gap"][0] < 1e-5
    assert checks["out_gap"][0] < 1e-5
    assert checks["change_gap"][0] < 1e-3
    assert checks["moe_out_gap"][0] < 1e-5
    assert checks["mla_out_gap"][0] < 1e-5
    assert checks["pick_gap"][0] == 0.0
    assert checks["bias_gap"][0] == 0.0
    assert rate > 0


def test_the_stack_is_causal(f32):
    port, _ = _pair(14)
    x = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(15))
    later = x.clone()
    later[:, 12:] += torch.randn(2, 8, 64)

    def stack(h):
        for layer in port.layers:
            h = layer(h)
        return port.final_norm(h)

    with torch.no_grad():
        a, b = stack(x), stack(later)
    # Routing is per frame, so the earlier frames see exactly what they
    # saw.
    assert torch.equal(a[:, :12], b[:, :12])
    assert not torch.allclose(a[:, 12:], b[:, 12:])


def test_shipped_yaml_builds_the_published_widths():
    cfg = load_config(emg_enc_cfg="configs/emg_encoder/kanana_2_30b_a3b.yaml")
    with torch.device("meta"):
        model = init_emg_encoder(cfg, torch.float32)
    assert type(model) is EMGEncoderDeepseekV3
    assert sum(p.numel() for p in model.parameters()) == 2_640_623_408
    assert type(model.layers[0].mlp) is lfm2.SwiGLU
    assert tuple(model.layers[0].mlp.w1.weight.shape) == (6144, 2048)
    sparse = model.layers[4].mlp
    assert tuple(sparse.w1.shape) == (128, 768, 2048)
    assert sparse.top_k == 6 and sparse.dtype == torch.bfloat16
    assert sparse.routed_scaling_factor == 2.448
    assert tuple(sparse.shared_experts.w1.weight.shape) == (1536, 2048)
    attn = model.layers[4].self_attn
    assert tuple(attn.q_proj.weight.shape) == (32 * 192, 2048)
    assert tuple(attn.kv_a_proj_with_mqa.weight.shape) == (576, 2048)
    assert tuple(attn.kv_b_proj.weight.shape) == (32 * 256, 512)
    assert tuple(attn.o_proj.weight.shape) == (2048, 32 * 128)
    # The benchmark's configuration file states the same model.
    with open("portbench/configs/enc_kanana2_30b_a3b.json") as fp:
        bench = json.load(fp)
    params = drv.encoder_params(bench)
    for key, value in cfg.emg_encoder.params.items():
        assert params[key] == value, key


def test_cli_trains_the_kanana_yaml(tmp_path, f32):
    from ste_gan_torch.data.synthetic import generate_synthetic_corpus
    from ste_gan_torch.train import encoder as tenc

    shipped = yaml.safe_load(open(
        "configs/emg_encoder/kanana_2_30b_a3b.yaml"))
    shipped["params"].update({k: TINY[k] for k in (
        "model_size", "hidden_size", "num_attention_heads", "kv_lora_rank",
        "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "intermediate_size", "moe_intermediate_size", "n_routed_experts",
        "num_hidden_layers")})
    encoder_yaml = tmp_path / "encoder.yaml"
    encoder_yaml.write_text(yaml.safe_dump(shipped))
    root = tmp_path / "synthetic"
    generate_synthetic_corpus(root, num_train=8, num_valid=3, num_test=2,
                              num_sessions=2, min_frames=30, max_frames=50,
                              seed=6, silent_fraction=0.4)
    data_yaml = tmp_path / "data.yaml"
    data_yaml.write_text(yaml.safe_dump(
        {"dataset_root": str(root), "name": "synthetic",
         "num_emg_sessions": 2, "num_emg_channels": 8}))
    tenc.main(tenc.parse_args([
        "--data", str(data_yaml), "--emg_enc_cfg", str(encoder_yaml),
        "--exp_dir", str(tmp_path / "exp"), "--num_epochs", "1",
        "--max_batch_len", "3200", "--warmup_steps", "5",
        "--transfer_dtype", "float32", "--device", "cpu",
        "--include_silent"]))
    run = tmp_path / "exp" / tenc.create_output_dir_name(
        root, "EMGEncoderDeepseekV3_mixed")
    assert (run / ".done").exists()
    state = torch.load(run / "last_model.pt", weights_only=True)
    biases = [v for k, v in state.items() if k.endswith("expert_bias")]
    assert len(biases) == 2 and any(bool(b.abs().sum() > 0) for b in biases)
    cfg = load_config(emg_enc_cfg=str(encoder_yaml))
    model = init_emg_encoder(cfg, torch.float32)
    model.load_state_dict(state, strict=True)


def test_export_and_quant_refuse_it_and_embed_works(f32):
    from ste_gan_torch.export import export_emg_encoder
    from ste_gan_torch.quant import export_emg_encoder_quantized
    from ste_gan_torch.realism import encoder_embed_fn

    port, _ = _pair(16)
    for fn in (export_emg_encoder, export_emg_encoder_quantized):
        with pytest.raises(NotImplementedError,
                           match="EMGEncoderDeepseekV3"):
            fn(port, 8)
    out = encoder_embed_fn(port.eval())(_emg(17, windows=1).numpy())
    assert out.shape == (1, 100, 64) and np.isfinite(out).all()


def test_one_device_only(f32):
    from ste_gan_torch.train import encoder as tenc

    port, _ = _pair(18)
    with pytest.raises(NotImplementedError, match="one device"):
        tenc.make_encoder_train_step(port, 64, group=object())
    with pytest.raises(NotImplementedError, match="EMGEncoderDeepseekV3"):
        port(_emg(19, windows=1), group=object())


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.card
def test_mla_at_the_published_widths_on_the_card(card):
    """bf16 MLA (32 heads, latent 512, heads of 128 + 64 and 128) against
    the reference at the stated precision (bf16 operands, f32 sums): the
    two round differently only inside the attention kernel, 2e-2 of the
    output's norm at most."""
    torch.manual_seed(20)
    mla = deepseek_v3.MLA(2048, 32, 512, 128, 64, 128, 1e6, 1e-6,
                          torch.bfloat16).to(card)
    mla_r = ref.MLA(2048, 32, 512, 128, 64, 128, 1e-6, 1e6).to(card)
    mla_r.load_state_dict(mla.state_dict())
    x = torch.randn(8, 100, 2048, device=card, requires_grad=True)
    y = mla(x)
    stated = Precision(torch.float32, tf32=True,
                       products=Precision(torch.bfloat16))
    with torch.no_grad(), stated.active():
        y_r = mla_r(x, stated)
    assert float((y.float() - y_r).norm() / y_r.norm()) < 2e-2
    torch.autograd.grad(y.float().sum(), [x, mla.q_proj.weight])


@pytest.mark.card
def test_shared_expert_block_never_waits_for_the_host(card):
    block = moe.DroplessMoE(
        2048, 128, 768, 6, True, 2.448, True, torch.bfloat16,
        shared=lfm2.SwiGLU(2048, 1536, torch.bfloat16),
        gate_eps=deepseek_v3.GATE_EPS).to(card)
    x = torch.randn(2, 400, 2048, device=card, requires_grad=True)
    block(x, train=True)  # warm the caches up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = block(x, train=True)
        torch.autograd.grad(F.silu(y).sum(), [
            x, block.w1, block.gate.weight, block.shared_experts.w1.weight])
        block.update_bias()
    finally:
        torch.cuda.set_sync_debug_mode(0)
