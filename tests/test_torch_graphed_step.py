"""The GAN step's CUDA-graph replay of the generator and the frozen encoder
(``ste_gan_torch/train/graphed.py``).

On the CPU (tier-1): the engagement rule, reason by reason; the step on
the CPU, under ``train.remat`` and with a tensor-parallel layer runs every
call eagerly and counts it, with no capture; and, with the device check
and the capture stood in by an eager call, the bookkeeping of the step:
per network the first call eager, the second captured and served, later
ones served, forward hooks on every call. The signatures and their bound
are ``tests/test_torch_graph_keys.py``'s.

On the card (marked ``card``; they skip without one): six graphed steps
against six eager ones from the same weights and batches, K = 1 and K = 2,
bit for bit: every metric, the change of every parameter and of the EMA,
the spectral-norm vectors; the counters; a forward hook on the generator
on every step; then the eval step and synthesis at other shapes, eagerly,
and one step more after the EMA swaps. They run with cuDNN's
deterministic algorithms: by default the discriminator's cuDNN gradients
differ from run to run by ~1e-7, which AdamW's normalised update spreads
to ~1e-3 of a parameter's change over six steps, eager against eager as
much as graphed against eager. Run them on a machine with a card with

    python -m pytest tests/test_torch_graphed_step.py --noconftest -q

(``--noconftest``: the suite's conftest loads JAX, which that machine
lacks; nothing here needs it).
"""
import contextlib

import numpy as np
import pytest
import torch

from ste_gan_torch.config import Config
from ste_gan_torch.models.discriminator import DiscriminatorEnsemble
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_torch.models.moe import MoEFeedForward
from ste_gan_torch.ops.conv import WNConv, _ConvBase
from ste_gan_torch.parallel.tensor_parallel import ModelShard
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train import graphed
from ste_gan_torch.utils import profiling

ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)
COUNTERS = (graphed.EAGER, graphed.CAPTURES, graphed.REPLAYS)
STEPS = 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _counts(before) -> dict:
    got = profiling.since(before)
    return {name: int(got.get(name, (0, 0))[0]) for name in COUNTERS}


# ---------------------------------------------------------------------------
# CPU: the engagement rule
# ---------------------------------------------------------------------------


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = WNConv(4, 4, 3, padding=1)
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x):
        return self.lin(self.conv(x).transpose(1, 2))


def _mark_tp(net):
    """Marks the first conv of ``net`` as a tensor-parallel shard of one
    rank, which computes what the unmarked layer does."""
    conv = next(m for m in net.modules() if isinstance(m, _ConvBase))
    conv.tp = ModelShard(None, 0, 1, None, conv.groups)


@pytest.mark.parametrize("case, reason", [
    ("cpu", "not on CUDA"),
    ("remat", "the step recomputes it (train.remat)"),
    ("no_grad", "grad mode is off"),
    ("tp", "a tensor-parallel layer"),
    ("moe", "routing by value (MoE)"),
    ("pre_hook", "a hook inside the forward"),
    ("inner_hook", "a hook inside the forward"),
    ("global_hook", "a global module hook"),
])
def test_engagement_rule(case, reason, monkeypatch):
    """Each condition alone keeps the call eager, whatever the device; with
    none, only the CPU does."""
    net = _Net()
    if case == "moe":
        net.moe = MoEFeedForward(4, 2, 8, 1, 1.0)
    if case == "tp":
        _mark_tp(net)
    if case == "pre_hook":
        net.register_forward_pre_hook(lambda m, a: None)
    if case == "inner_hook":
        net.lin.register_forward_hook(lambda m, a, o: None)
    handle = (torch.nn.modules.module.register_module_forward_hook(
        lambda m, a, o: None) if case == "global_hook" else None)
    call = graphed.GraphedCall(net, capturable=case != "remat")
    x = torch.zeros(2, 4, 5)
    grad = torch.no_grad() if case == "no_grad" else contextlib.nullcontext()
    try:
        with grad:
            assert call.eager_reason((x,)) == reason
            if case != "cpu":
                monkeypatch.setattr(graphed, "_on_cuda", lambda t: True)
                assert call.eager_reason((x,)) == reason
    finally:
        if handle is not None:
            handle.remove()


def _tiny_gan(accum: int = 1, remat: bool = False):
    cfg = Config()
    cfg.train.chunk_size = 256
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.train.grad_accum = accum
    cfg.train.remat = remat
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


class _EagerGraphs:
    """Stands in for a capture on the CPU: runs the forward eagerly."""

    def __init__(self, module, args):
        self.module = module

    def run(self, args):
        return self.module.forward(*args)


def _run_steps(cfg, models, steps: int):
    state = tgan.init_state(cfg, models)
    step = tgan.make_train_step(cfg, models)
    calls = []
    models.generator.register_forward_hook(
        lambda m, a, out: calls.append(out.shape))
    before = profiling.counters()
    metrics = []
    for i in range(steps):
        state, m = step(state, tgan.synthetic_batch(cfg, "cpu", seed=i))
        metrics.append({k: v.clone() for k, v in m.items()})
    return metrics, _counts(before), calls, state


@pytest.mark.parametrize("case", ["cpu", "remat", "tp"])
def test_step_stays_eager_without_capture(case, monkeypatch):
    """On the CPU, with ``train.remat`` and with a tensor-parallel conv
    (the last two also where the device check is made to pass), every
    generator and encoder call of the step runs eagerly and is counted;
    nothing is captured or replayed, and the numbers are the plain step's."""
    cfg, models = _tiny_gan(remat=case == "remat")
    if case == "tp":
        _mark_tp(models.generator)
        _mark_tp(models.encoder)
    if case != "cpu":
        monkeypatch.setattr(graphed, "_on_cuda", lambda t: True)
        monkeypatch.setattr(graphed, "_Graphs", None)
    got, counts, _, _ = _run_steps(cfg, models, 3)
    # Under remat the checkpoint runs each network's forward twice a step.
    calls_per_step = 4 if case == "remat" else 2
    assert counts == {graphed.EAGER: calls_per_step * 3, graphed.CAPTURES: 0,
                      graphed.REPLAYS: 0}
    monkeypatch.undo()
    cfg0, models0 = _tiny_gan(remat=case == "remat")
    want, _, _, _ = _run_steps(cfg0, models0, 3)
    for w, g in zip(want, got):
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=0)


@pytest.mark.parametrize("accum", [1, 2])
def test_step_bookkeeping_with_stand_in_capture(accum, monkeypatch):
    """With the device check passed and the capture stood in by an eager
    call: per network the first call eager, the second captured, every
    call after it served; a hook on the generator on every step; the
    numbers are the plain step's."""
    cfg, models = _tiny_gan(accum)
    monkeypatch.setattr(graphed, "_on_cuda", lambda t: True)
    monkeypatch.setattr(graphed, "_Graphs", _EagerGraphs)
    got, counts, calls, _ = _run_steps(cfg, models, STEPS)
    calls_per_net = STEPS * accum
    assert counts == {graphed.EAGER: 2, graphed.CAPTURES: 2,
                      graphed.REPLAYS: 2 * (calls_per_net - 1)}
    # The D phase's no-grad forwards call the module itself.
    assert len(calls) == STEPS * (2 * accum - (accum == 1))
    monkeypatch.undo()
    cfg0, models0 = _tiny_gan(accum)
    want, plain, _, _ = _run_steps(cfg0, models0, STEPS)
    assert plain == {graphed.EAGER: 2 * calls_per_net, graphed.CAPTURES: 0,
                     graphed.REPLAYS: 0}
    for w, g in zip(want, got):
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=0)


@pytest.mark.parametrize("counters, want", [
    ({graphed.REPLAYS: (20.0, 20), graphed.EAGER: (4.0, 4)}, 100 * 20 / 24),
    ({graphed.REPLAYS: (24.0, 24)}, 100.0),
    ({graphed.EAGER: (24.0, 24), "gan/g_forward": (0.1, 12)}, 0.0),
    ({"gan/g_forward": (0.1, 12)}, None),
    (None, None),
])
def test_graph_replay_pct_reader(counters, want, monkeypatch):
    """The benchmark's ``graph_replay_pct.gan_train``: replays over the
    graphable calls of the untraced stretch; nothing from a program
    without the counters or without the spans' module."""
    import types

    from portbench import phases, spec

    if counters is None:
        monkeypatch.setattr(phases, "program_profiling", lambda: None)
        stash = {}
    else:
        stash = {"phases.untraced": {"units": 12.0, "seconds": 1.0,
                                     "counters": counters}}
    run = types.SimpleNamespace(stash=stash, config={})
    got = spec.reader("graph_replay_pct.gan_train")(run)
    assert got == (None if want is None else pytest.approx(want))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _narrow(accum: int) -> Config:
    cfg = Config()
    cfg.train.chunk_size, cfg.train.batch_size = 512, 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.train.grad_accum = accum
    cfg.model.params = {"channels": 32}
    cfg.emg_encoder.params = dict(ENC_KW)
    return cfg


def _card_run(cfg, device, eager: bool, monkeypatch):
    """``STEPS`` steps from seed 0's weights on seeded batches: metrics,
    parameter changes, EMA changes, spectral vectors, counters and the
    hook's calls."""
    models = tgan.build_models(cfg, seed=0, device=device)
    before_p = {n: p.detach().clone() for n, p in
                models.generator.named_parameters()}
    before_p.update({"d." + n: p.detach().clone() for n, p in
                     models.discriminator.named_parameters()})
    state = tgan.init_state(cfg, models)
    ema0 = [e.clone() for e in state.gen_ema]
    step = tgan.make_train_step(cfg, models)
    hooked = []
    models.generator.register_forward_hook(
        lambda m, a, out: hooked.append(float(out.detach().abs().sum())))
    with monkeypatch.context() as mp:
        if eager:
            mp.setattr(graphed, "_on_cuda", lambda t: False)
        before = profiling.counters()
        metrics = []
        for i in range(STEPS):
            state, m = step(state, tgan.synthetic_batch(cfg, device,
                                                        seed=100 + i))
            metrics.append({k: v.double().cpu() for k, v in m.items()})
        counts = _counts(before)
    changes = {n: (p.detach() - before_p[n]).cpu() for n, p in
               models.generator.named_parameters()}
    changes.update({"d." + n: (p.detach() - before_p["d." + n]).cpu()
                    for n, p in models.discriminator.named_parameters()})
    ema = [(e - e0).cpu() for e, e0 in zip(state.gen_ema, ema0)]
    sn = {n: b.detach().cpu().clone() for n, b in
          models.discriminator.named_buffers()
          if n.endswith(("weight_u", "weight_v"))}
    return dict(metrics=metrics, changes=changes, ema=ema, sn=sn,
                counts=counts, hooked=hooked, models=models, state=state,
                step=step)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _worst(g, e) -> float:
    gaps = [_rel(g["metrics"][i][k], e["metrics"][i][k])
            for i in range(STEPS) for k in e["metrics"][i]]
    gaps += [_rel(g["changes"][n], e["changes"][n]) for n in e["changes"]]
    gaps += [_rel(a, b) for a, b in zip(g["ema"], e["ema"])]
    gaps += [_rel(g["sn"][n], e["sn"][n]) for n in e["sn"]]
    return max(gaps)


@pytest.mark.card
@pytest.mark.parametrize("accum", [1, 2])
def test_graphed_steps_match_eager_on_the_card(card, accum, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = _narrow(accum)
    eager = _card_run(cfg, card, True, monkeypatch)
    graphs = _card_run(cfg, card, False, monkeypatch)
    calls_per_net = STEPS * accum
    assert eager["counts"] == {graphed.EAGER: 2 * calls_per_net,
                               graphed.CAPTURES: 0, graphed.REPLAYS: 0}
    assert graphs["counts"] == {graphed.EAGER: 2, graphed.CAPTURES: 2,
                                graphed.REPLAYS: 2 * (calls_per_net - 1)}
    worst = _worst(graphs, eager)
    print(f"graphed vs eager, K={accum}: worst relative gap {worst:.3e}")
    assert worst == 0
    # The hook saw every generator call (the D phase's no-grad ones too).
    per_step = 2 * accum - (accum == 1)
    assert len(graphs["hooked"]) == len(eager["hooked"]) == STEPS * per_step
    assert graphs["hooked"] == eager["hooked"]

    # Eval and synthesis at other shapes run eagerly beside the graphs.
    from ste_gan_torch.infer import EMGSynthesizer

    wide = _narrow(accum)
    wide.train.batch_size, wide.train.chunk_size = 3, 768
    before = profiling.counters()
    out = {}
    for name, run in (("graphed", graphs), ("eager", eager)):
        m, s = run["models"], run["state"]
        with tgan.eval_generator_params(m, s):
            val = tgan.make_eval_step(wide, m)(
                tgan.synthetic_batch(wide, card, seed=7))
        synth = EMGSynthesizer.from_config(
            wide, tgan.eval_generator_state_dict(m, s), device=card)
        emg = synth.synthesize(np.random.default_rng(3).normal(
            size=(37, 256)).astype(np.float32), 1)
        out[name] = (val, emg)
    assert _counts(before) == dict.fromkeys(COUNTERS, 0)
    for k in out["eager"][0]:
        assert _rel(out["graphed"][0][k], out["eager"][0][k]) == 0
    assert out["graphed"][1].shape == (37 * 16, 8)
    np.testing.assert_array_equal(out["graphed"][1], out["eager"][1])

    # One step more after the EMA swaps: the replay reads the parameters
    # the swaps restored in place (the eager run's first call of the
    # signature runs eagerly).
    batch = tgan.synthetic_batch(cfg, card, seed=200)
    before = profiling.counters()
    _, last_g = graphs["step"](graphs["state"], dict(batch))
    assert _counts(before)[graphed.REPLAYS] == 2 * accum
    _, last_e = eager["step"](eager["state"], dict(batch))
    for k in last_e:
        assert _rel(last_g[k].cpu(), last_e[k].cpu()) == 0
