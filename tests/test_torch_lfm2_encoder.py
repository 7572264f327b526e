"""The port's LFM2 encoder (``EMGEncoderLFM2``: LFM2-8B-A1B's block stack
behind the published encoder's front end) against the plain reference
``portbench/reference/lfm2.py``, f32 on the CPU at narrow widths that keep
the published layer pattern (``layer_types[0:8]``: 2 dense then 6 sparse
layers, 6 gated short convs and 2 GQA attention layers) with 8 experts
top-4.

The products run in f32 here (``models/lfm2.py``'s ``COMPUTE_DTYPE``
patched by the ``f32`` fixture); the shipped type runs them in bf16.

* One training forward, a loss of both heads and the gradients of every
  parameter, and the BatchNorm statistics it moves.
* Three steps of the benchmark cell's own path (the trainer's fold,
  sampler, ``make_encoder_train_step``, AdamW and the bias updates)
  against the reference's steps: losses, parameter changes, outputs, and
  each sparse block's output, picks and bias update on its own input.
* The routing: the same picks as the reference under a nonzero expert
  bias, every pick computed, and the counters.
* Causality of the stack; the grouped expert products against a loop
  over the experts; the dense and capacity-MoE encoders built as before.
* The encoder CLI on the LFM2 yaml, export refusing it, ``embed``.

On the card (marked ``card``; they skip without one): routing and the
grouped products under CUDA's sync debug mode (no wait for the host), and
the bf16 grouped products against the loop.
"""
import json
import math

import numpy as np
import pytest
import torch
import yaml

from portbench.drivers import enc_train_lfm2 as drv
from portbench.reference import lfm2 as ref
from portbench.reference import nets
from ste_gan_torch.config import load_config
from ste_gan_torch.models import lfm2, moe
from ste_gan_torch.models.emg_encoder import (EMGEncoderLFM2,
                                              EMGEncoderTransformer,
                                              init_emg_encoder)
from ste_gan_torch.utils import profiling

#: Narrow widths; every layer kind and the published pattern kept.
TINY = dict(model_size=32, num_extra_res_blocks=3, hidden_size=64,
            num_hidden_layers=8, layer_types=list(ref.LAYER_TYPES),
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, moe_intermediate_size=32,
            num_dense_layers=2, num_experts=8, num_experts_per_tok=4,
            conv_L_cache=3, norm_eps=1e-5, rope_theta=1e6)


@pytest.fixture
def f32(monkeypatch):
    """The LFM2 encoder's products in f32, as the f32 reference's."""
    monkeypatch.setattr(lfm2, "COMPUTE_DTYPE", torch.float32)


def _pair(seed: int = 0):
    """The port's encoder (seeded init) and the reference with its
    weights, f32."""
    port = EMGEncoderLFM2(**TINY, generator=torch.Generator().manual_seed(
        seed))
    with torch.no_grad():
        for block in port.layers[2:]:
            block.feed_forward.expert_bias.copy_(torch.linspace(
                -0.02, 0.02, 8)[torch.randperm(
                    8, generator=torch.Generator().manual_seed(seed))])
    reference = ref.LFM2Encoder(**ref.config_sizes(TINY))
    reference.load_state_dict(port.state_dict(), strict=True)
    return port, reference


def _emg(seed: int, windows: int = 3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.tanh(rng.normal(0, 0.5, (windows, 1600, 8))
                                    ).astype(np.float32))


def test_forward_loss_and_gradients_match_the_reference(f32):
    port, reference = _pair(1)
    x = _emg(2)
    r1 = torch.randn(3, 100, nets.UNIT_DIM,
                     generator=torch.Generator().manual_seed(3))
    r2 = torch.randn(3, 100, nets.PHONEMES,
                     generator=torch.Generator().manual_seed(4))
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
    grads = torch.autograd.grad(loss, list(port.parameters()))
    grads_r = torch.autograd.grad(loss_r, [params_r[n] for n in names])
    # A conv bias ahead of a BatchNorm has no gradient but round-off:
    # each leaf within 1e-4 of its own norm or 1e-6 of the largest.
    largest = max(float(g.norm()) for g in grads_r)
    for name, g, g_r in zip(names, grads, grads_r):
        assert float((g - g_r).norm()) <= (1e-4 * float(g_r.norm())
                                           + 1e-6 * largest), name
    buffers_r = dict(reference.named_buffers())
    for name, b in port.named_buffers():
        torch.testing.assert_close(b.float(), buffers_r[name].float(),
                                   rtol=1e-5, atol=1e-6, msg=name)


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
    # The sparse blocks are held to the reference's at the stated
    # precision: f32 here, as the program's products.
    over["config"]["control"] = {"stated": {"products": {
        "dtype": "float32"}}}
    cell = spec.load_cell("enc_lfm2.train_mixed", overrides=over)
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
    assert checks["pick_gap"][0] == 0.0
    assert checks["bias_gap"][0] == 0.0
    assert rate > 0


def test_same_picks_as_the_reference_and_none_dropped(f32):
    port, reference = _pair(5)
    block = port.layers[4].feed_forward
    block_r = reference.layers[4].feed_forward
    tokens = torch.randn(300, 64, generator=torch.Generator().manual_seed(6))
    chosen, gates = block.route(tokens)
    before = profiling.counters()
    out = block(tokens.view(3, 100, 64), train=True)
    added = profiling.since(before)
    out_r = block_r(tokens.view(3, 100, 64), ref.F32)
    torch.testing.assert_close(out, out_r, rtol=1e-5, atol=1e-6)
    # The reference's picks: the same experts, token by token.
    scores = torch.sigmoid(tokens @ block_r.gate.weight.T)
    want = torch.topk(scores + block_r.expert_bias, 4).indices
    assert torch.equal(chosen.sort(dim=1).values, want.sort(dim=1).values)
    assert torch.allclose(gates.sum(dim=1), torch.ones(300), atol=1e-5)
    assert torch.equal(block.load, block_r.load.to(torch.int64))
    assert int(block.load.sum()) == 1200
    assert added["moe/picks"][0] == 1200
    assert "moe/dropped" not in added
    assert added["moe/max_load"][0] == float(block.load.max())
    # The bias update: sign(mean - load) times the rate, as the reference.
    bias = block.expert_bias.clone()
    block.update_bias()
    block_r.update_bias()
    torch.testing.assert_close(block.expert_bias, block_r.expert_bias)
    assert not torch.equal(bias, block.expert_bias)


def test_the_stack_is_causal(f32):
    port, _ = _pair(7)
    x = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(8))
    later = x.clone()
    later[:, 12:] += torch.randn(2, 8, 64)

    def stack(h):
        for layer in port.layers:
            h = layer(h)
        return port.final_norm(h)

    with torch.no_grad():
        a, b = stack(x), stack(later)
    assert torch.equal(a[:, :12], b[:, :12])
    assert not torch.allclose(a[:, 12:], b[:, 12:])


def test_grouped_products_equal_a_loop_over_the_experts():
    g = torch.Generator().manual_seed(9)
    e, d, f = 5, 16, 24
    counts = [7, 0, 12, 1, 20]
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int32)
    xs = torch.randn(sum(counts), d, generator=g, requires_grad=True)
    w1 = (0.3 * torch.randn(e, f, d, generator=g)).requires_grad_()
    w3 = (0.3 * torch.randn(e, f, d, generator=g)).requires_grad_()
    w2 = (0.3 * torch.randn(e, d, f, generator=g)).requires_grad_()
    dy = torch.randn(sum(counts), d, generator=g)
    y = moe.grouped_swiglu(xs, w1, w3, w2, ends)
    got = torch.autograd.grad(y, (xs, w1, w3, w2), dy)
    starts = [0] + list(np.cumsum(counts)[:-1])
    loop = torch.cat([
        (torch.nn.functional.silu(xs[s:s + n] @ w1[i].T)
         * (xs[s:s + n] @ w3[i].T)) @ w2[i].T
        for i, (s, n) in enumerate(zip(starts, counts))])
    want = torch.autograd.grad(loop, (xs, w1, w3, w2), dy)
    torch.testing.assert_close(y, loop, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1][1], torch.zeros(f, d))


@pytest.mark.parametrize("yaml_path", [
    "configs/emg_encoder/conv_transformer.yaml",
    "configs/emg_encoder/conv_transformer_moe.yaml"])
def test_dense_and_capacity_moe_encoders_unchanged(yaml_path):
    """Both shipped transformer encoders still build as the relative-
    position transformer; the dense one's forward equals the reference
    encoder's with the same weights, the MoE one keeps its capacity rule
    and load-balancing loss."""
    cfg = load_config(emg_enc_cfg=yaml_path)
    cfg.emg_encoder.params.update(model_size=32, num_transformer_layers=1,
                                  num_heads=2, dim_feedforward=64, dropout=0.0)
    model = init_emg_encoder(cfg, torch.float32,
                             torch.Generator().manual_seed(10))
    assert type(model) is EMGEncoderTransformer
    x = _emg(11, windows=2)
    ffn = model.transformer.layers[0].moe_ffn
    if ffn is None:
        reference = nets.Encoder(model_size=32, layers=1, heads=2, ffn=64)
        reference.load_state_dict(model.state_dict(), strict=True)
        with torch.no_grad(), ref.F32.active():
            want = reference(x)
            got = model(x)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    else:
        assert type(ffn) is moe.MoEFeedForward
        assert ffn.capacity(8000) == math.ceil(1.5 * 2 * 8000 / 4)
        before = profiling.counters()
        model(x, train=True, generator=torch.Generator().manual_seed(0))
        assert model.pop_moe_aux_loss() is not None
        # Its spans and counters: 200 frames, top-2 of 4 experts.
        added = profiling.since(before)
        assert {"enc/moe/route", "enc/moe/experts",
                "enc/moe/combine"} <= set(added)
        assert added["moe/picks"][0] == 400
        assert added["moe/dropped"][0] == float(ffn.dropped)


def test_shipped_yaml_builds_the_published_widths():
    cfg = load_config(emg_enc_cfg="configs/emg_encoder/lfm2_8b_a1b.yaml")
    with torch.device("meta"):
        model = init_emg_encoder(cfg, torch.float32)
    assert type(model) is EMGEncoderLFM2
    assert sum(p.numel() for p in model.parameters()) == 2_340_515_376
    kinds = [layer.kind for layer in model.layers]
    assert kinds == list(ref.LAYER_TYPES[:8])
    sparse = model.layers[7].feed_forward
    assert tuple(sparse.w1.shape) == (32, 1792, 2048)
    assert sparse.top_k == 4 and sparse.dtype == torch.bfloat16
    attn = model.layers[2].self_attn
    assert (attn.heads, attn.kv_heads, attn.head_dim) == (32, 8, 64)
    assert tuple(model.layers[0].feed_forward.w1.weight.shape) == (7168, 2048)
    # The benchmark's configuration file states the same model.
    with open("portbench/configs/enc_lfm2_8b_a1b.json") as fp:
        bench = json.load(fp)
    params = drv.encoder_params(bench)
    for key, value in cfg.emg_encoder.params.items():
        assert params[key] == value, key


def test_cli_trains_the_lfm2_yaml(tmp_path, f32):
    from ste_gan_torch.data.synthetic import generate_synthetic_corpus
    from ste_gan_torch.train import encoder as tenc

    shipped = yaml.safe_load(open("configs/emg_encoder/lfm2_8b_a1b.yaml"))
    shipped["params"].update({k: TINY[k] for k in (
        "model_size", "hidden_size", "num_attention_heads",
        "num_key_value_heads", "intermediate_size", "moe_intermediate_size",
        "num_experts")})
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
        root, "EMGEncoderLFM2_mixed")
    assert (run / ".done").exists()
    state = torch.load(run / "last_model.pt", weights_only=True)
    biases = [v for k, v in state.items() if k.endswith("expert_bias")]
    assert len(biases) == 6 and any(bool(b.abs().sum() > 0) for b in biases)
    cfg = load_config(emg_enc_cfg=str(encoder_yaml))
    model = init_emg_encoder(cfg, torch.float32)
    model.load_state_dict(state, strict=True)


def test_export_refuses_it_and_embed_works(f32):
    from ste_gan_torch.export import export_emg_encoder
    from ste_gan_torch.quant import export_emg_encoder_quantized
    from ste_gan_torch.realism import encoder_embed_fn

    port, _ = _pair(12)
    for fn in (export_emg_encoder, export_emg_encoder_quantized):
        with pytest.raises(NotImplementedError, match="EMGEncoderLFM2"):
            fn(port, 8)
    out = encoder_embed_fn(port.eval())(_emg(13, windows=1).numpy())
    assert out.shape == (1, 100, 64) and np.isfinite(out).all()


def test_one_device_only(f32):
    from ste_gan_torch.train import encoder as tenc

    port, _ = _pair(14)
    with pytest.raises(NotImplementedError, match="one device"):
        tenc.make_encoder_train_step(port, 64, group=object())


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.card
def test_routing_and_experts_never_wait_for_the_host(card):
    block = moe.DroplessMoE(2048, 32, 1792, 4).to(card)
    x = torch.randn(2, 400, 2048, device=card, requires_grad=True)
    block(x, train=True)  # warm the caches up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = block(x, train=True)
        torch.autograd.grad(y.sum(), [x, block.w1, block.gate.weight])
        block.update_bias()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.card
def test_bf16_grouped_products_on_the_card(card):
    g = torch.Generator(device=card).manual_seed(15)
    e, d, f = 32, 2048, 1792
    counts = torch.randint(0, 2000, (e,), generator=g, device=card)
    counts[3] = 0
    ends = torch.cumsum(counts, 0).to(torch.int32)
    rows = int(ends[-1])
    bf = torch.bfloat16
    xs = torch.randn(rows, d, generator=g, device=card, dtype=bf)
    w1, w3 = (0.02 * torch.randn(e, f, d, generator=g, device=card)
              ).to(bf), (0.02 * torch.randn(e, f, d, generator=g,
                                            device=card)).to(bf)
    w2 = (0.02 * torch.randn(e, d, f, generator=g, device=card)).to(bf)
    y = moe.grouped_swiglu(xs, w1, w3, w2, ends)
    bounds = [0] + ends.tolist()
    loop = torch.cat([
        (torch.nn.functional.silu(xs[a:b].float() @ w1[i].float().T)
         * (xs[a:b].float() @ w3[i].float().T)) @ w2[i].float().T
        for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))])
    assert float((y.float() - loop).norm() / loop.norm()) < 2e-2
