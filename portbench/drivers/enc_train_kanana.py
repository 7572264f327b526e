"""Encoder pre-training with kanana-2-30b-a3b's DeepSeek-V3 block stack:
the encoder trainer's per-step path on ``EMGEncoderDeepseekV3``.

As ``drivers/enc_train_lfm2.py`` (the corpus drawn from the seed on the
card, ``SizeAwareSampler`` behind ``Prefetcher``, the fold on the card,
the warm-up learning rate, ``make_encoder_train_step``, the seeded weight
of each leaf by its name, the balanced start, the sparse blocks' record
and their numbers), with these differences:

* the program's encoder is ``EMGEncoderDeepseekV3`` built by
  ``init_emg_encoder`` from the config file's ``program`` part with the
  architecture's published keys (the file's top level) laid over its
  parameters; the keys the stack has one value for are checked
  (:data:`WRITTEN`);
* the reference is ``reference/kanana.py``'s ``KananaEncoder``;
* each MLA block's input and output in the first step's forward are kept
  too, and the reference's MLA at the configuration's stated precision is
  held to them on the same input (:func:`mla_numbers`, ``mla_out_gap``);
* the stand-in side of a number (``control_kanana.py``'s) may be the
  reference at another precision as well as with another ``Variant``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import compare
from portbench.drivers import common, enc_train
from portbench.drivers import enc_train_lfm2 as lfm2_drv
from portbench.drivers.enc_train import (  # noqa: F401
    _stream_seed, release, traced, window)
from portbench.drivers.enc_train_lfm2 import (
    SparseRecord, balanced_bias, pick_share, stated)
from portbench.reference import kanana as ref_kanana
from portbench.reference import lfm2 as ref_lfm2
from portbench.reference import nets as ref_nets
from portbench.reference import train as ref_train
from portbench.reference.precision import F32, Precision
from portbench.weights import seeded_state

#: The architecture's keys at the config file's top level that the
#: program's encoder takes as they are (kanana-2-30b-a3b's ``config.json``).
ARCH_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
             "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
             "v_head_dim", "intermediate_size", "moe_intermediate_size",
             "first_k_dense_replace", "n_routed_experts",
             "num_experts_per_tok", "n_shared_experts", "norm_topk_prob",
             "routed_scaling_factor", "rms_norm_eps", "rope_theta")
#: The published keys the stack is written for one value of.
WRITTEN = {"q_lora_rank": None, "n_group": 1, "topk_group": 1,
           "scoring_func": "sigmoid", "topk_method": "noaux_tc",
           "rope_interleave": True, "rope_scaling": None,
           "hidden_act": "silu", "attention_bias": False,
           "moe_layer_freq": 1}


def encoder_params(config: Dict) -> Dict:
    """``EMGEncoderDeepseekV3``'s keyword arguments: the program part's
    parameters with the architecture's keys laid over them."""
    for key, value in WRITTEN.items():
        if config[key] != value:
            raise ValueError(f"{key}={config[key]!r}: the stack is written "
                             f"for {value!r} only")
    params = dict(config["program"]["emg_encoder"]["params"])
    params.update({k: config[k] for k in ARCH_KEYS})
    return params


def program_config(config: Dict):
    from ste_gan_torch.config import config_from_dict

    prog = dict(config["program"])
    prog["emg_encoder"] = dict(prog["emg_encoder"],
                               params=encoder_params(config))
    return config_from_dict(prog)


def reference_module(config: Dict) -> ref_kanana.KananaEncoder:
    """The reference encoder of ``config`` on the meta device."""
    channels = config["program"]["data"]["num_emg_channels"]
    with torch.device("meta"):
        return ref_kanana.KananaEncoder(**ref_kanana.config_sizes(
            encoder_params(config), channels))


class Weights(lfm2_drv.Weights):
    """``enc_train_lfm2.Weights`` over this configuration's reference:
    the front end as the published encoder's, norms 1, expert biases 0,
    every other leaf N(0, ``INIT_STD``) seeded with the run's seed and the
    leaf's name, a leaf named in ``fixed`` taking that value."""

    def __init__(self, config: Dict, seed: int, device,
                 fixed: Optional[Dict[str, torch.Tensor]] = None):
        self.seed, self.device = int(seed), device
        self.fixed = fixed or {}
        meta = reference_module(config)
        front = torch.nn.Module()
        for name in ("conv_blocks", "w_raw_in", "w_out", "w_aux"):
            setattr(front, name, getattr(meta, name))
        self.front = seeded_state(
            [("e", front)], common.torch_gen(seed, common.WEIGHTS, device)
            .initial_seed(), device)["e"]
        self.shapes = {n: tuple(t.shape) for n, t in meta.state_dict().items()}


def balanced_start(config: Dict, seed: int, device, emg: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """``enc_train_lfm2.balanced_start`` on this stack: the input
    projection's bias centring its outputs over the windows ``emg [W, L,
    8]``, then each sparse block's expert bias balanced over its own
    scores just ahead of it, the balanced blocks before it in place (the
    f32 reference with the seeded leaves, training mode)."""
    enc = Weights(config, seed, device).fill(reference_module(config))
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad(), F32.active():
        x = emg.float().transpose(1, 2)
        for block in enc.conv_blocks:
            x = block(x, F32, True)
        proj = ref_nets.linear(x.transpose(1, 2), enc.w_raw_in, F32)
        enc.w_raw_in.bias -= proj.mean(dim=(0, 1))
    out["w_raw_in.bias"] = enc.w_raw_in.bias.detach().clone()

    def ahead(name):
        def hook(block, args):
            tokens = args[0].reshape(-1, args[0].shape[-1]).float()
            scores = torch.sigmoid(tokens @ block.gate.weight.T)
            block.expert_bias.copy_(balanced_bias(scores, block.top_k))
            out[f"{name}.expert_bias"] = block.expert_bias.detach().clone()
        return hook

    handles = [m.register_forward_pre_hook(ahead(n))
               for n, m in enc.named_modules()
               if isinstance(m, ref_kanana.SparseMoE)]
    with torch.no_grad(), F32.active():
        enc(emg.float(), F32, train=True)
    for h in handles:
        h.remove()
    return out


class MLARecord:
    """Each MLA block's input and output in the model's first training
    forward (on the host), by the block's name."""

    def __init__(self, model: torch.nn.Module):
        from ste_gan_torch.models.deepseek_v3 import MLA

        self.blocks: Dict[str, Dict[str, torch.Tensor]] = {}
        self.handles = [m.register_forward_hook(self._hook(n))
                        for n, m in model.named_modules()
                        if isinstance(m, MLA)]

    def _hook(self, name):
        def hook(block, args, out):
            if name not in self.blocks:
                self.blocks[name] = {
                    "x": args[0].detach().float().cpu().clone(),
                    "y": out.detach().float().cpu().clone()}
        return hook

    def close(self) -> Dict[str, Dict]:
        for h in self.handles:
            h.remove()
        return self.blocks


def setup(run) -> None:
    from ste_gan_torch.data.loader import Prefetcher, to_device
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.ops.fused_adamw import set_learning_rate
    from ste_gan_torch.train import encoder as tenc
    from ste_gan_torch.train.encoder_data import SizeAwareSampler

    cfg = program_config(run.config)
    t = run.traffic
    with torch.device("meta"):
        model = init_emg_encoder(cfg, torch.float32, torch.Generator())
    corpus, emg_lens, fr_lens, silent = enc_train.make_corpus(run)
    run.mark("corpus")
    max_len = int(t["max_len"])
    window_len = 8 * int(run.config["train"]["seq_len"])
    n_win = max(1, -(-max_len // window_len))
    # The balancing windows: the corpus's first samples, one batch's
    # worth.
    cal = min(n_win, corpus.emg_flat.shape[0] // window_len)
    start = balanced_start(
        run.config, run.seed, run.device,
        corpus.emg_flat[:cal * window_len].view(cal, window_len, -1))
    weights = Weights(run.config, run.seed, run.device, start)
    weights.fill(model)
    run.mark("program")

    max_samples = max(64, 2 * n_win, 16)
    sil = np.flatnonzero(silent)
    dims = {}
    silent_pred_frames = 0
    if len(sil):
        dims = {"max_silent": int(min(
                    len(sil), max_len // int(emg_lens[sil].min()) + 1)),
                "silent_target_frames": int(fr_lens[sil].max())}
        silent_pred_frames = int((emg_lens[sil] // 16).max())
    state = tenc.init_train_state(model, seed=_stream_seed(run))
    step = tenc.make_encoder_train_step(model, max_samples,
                                        silent_pred_frames=silent_pred_frames)
    sampler = SizeAwareSampler(emg_lens, max_len, seed=_stream_seed(run))
    keep = int(t["check_steps"])
    drawn: List[List[int]] = []

    def batches():
        while True:
            for index_batch in sampler:
                with run.span("draw"):
                    if len(drawn) < keep:
                        drawn.append(list(index_batch))
                    rows = np.zeros(max_samples, np.int32)
                    rows[:len(index_batch)] = index_batch
                    item = (to_device({"rows": rows, "num_samples": np.asarray(
                        len(index_batch), np.int32)}, run.device),
                        int(emg_lens[index_batch].sum()))
                yield item

    feed = iter(Prefetcher(batches, 2))
    pending = []
    counter = {"batch_idx": 0}
    warmup = int(run.config["train"]["warmup_steps"])
    target_lr = float(run.config["train"]["lr"])

    def one_step():
        nonlocal state
        idx, real = next(feed)
        with run.span("fold"):
            batch = corpus.fold(idx["rows"], idx["num_samples"], n_win=n_win,
                                max_samples=max_samples, **dims)
        lr = tenc.warmup_lr(counter["batch_idx"], target=target_lr,
                            warmup=warmup)
        set_learning_rate(state.opt, lr)
        with run.span("step"):
            state, metrics = step(state, batch)
        pending.append(torch.stack([metrics["loss"].double(),
                                    metrics["num_correct"].double(),
                                    metrics["num_frames"].double()]))
        counter["batch_idx"] += 1
        return metrics, real

    names = [n for n, _ in model.named_parameters()]
    losses, grads = [], {}
    b1 = float(np.float32(1) - np.float32(run.config["train"]["b1"]))
    first = compare.FirstOutputs(model, ("units", "phonemes"))
    sparse, mla = SparseRecord(model), MLARecord(model)
    for i in range(keep):
        metrics, _ = one_step()
        losses.append({"loss": float(metrics["loss"])})
        if i == 0:
            vals = torch.stack([m.norm() for m in state.opt.exp_avg]) / b1
            grads["enc"] = dict(zip(names, vals.cpu().tolist()))
            run.stash["sparse"] = sparse.close(model)
            run.stash["mla"] = mla.close()
    run.stash["prog"] = compare.Summary(
        losses, grads, {"enc": weights.change_norms(model)},
        compare.running_vars(model), outputs=first.outputs)
    run.stash["start"] = start
    run.mark("first steps")
    for _ in range(int(t["warmup_steps"])):
        one_step()
    pending.clear()
    run.mark("warm-up")
    run.stash.update(model=model, feed=feed, one_step=one_step,
                     corpus=corpus, drawn=drawn, n_win=n_win,
                     lens=(emg_lens, fr_lens, silent), pending=pending)


def reference_summary(run, precision: Precision = F32,
                      variant: ref_kanana.Variant = ref_kanana.PUBLISHED,
                      batches=None) -> compare.Summary:
    """The reference's check steps over the recorded batches from the
    run's seeded weights (the balanced biases among them) and shifts, in
    ``precision`` and with ``variant``."""
    weights = Weights(run.config, run.seed, run.device, run.stash["start"])
    enc = weights.fill(reference_module(run.config))
    batches = batches or enc_train.reference_batches(run)
    shifts = np.random.default_rng(_stream_seed(run))
    tr = run.config["train"]
    lrs = [min(i + 1, tr["warmup_steps"]) * tr["lr"] / tr["warmup_steps"]
           for i in range(len(batches))]
    rec = ref_lfm2.lfm2_steps(
        enc, batches, [int(shifts.integers(0, 8)) for _ in batches],
        ref_train.EncHyper(lrs=lrs, b1=tr["b1"], b2=tr["b2"], wd=tr["wd"],
                           dropout=0.0),
        precision, run.stash["n_win"], variant)
    changes = {"enc": weights.change_norms(enc)}
    return compare.Summary(rec.losses, rec.grads, changes, rec.stats,
                           outputs=rec.outputs)


def _part(run, weights: Weights, name: str, make) -> torch.nn.Module:
    with torch.device("meta"):
        module = make(encoder_params(run.config))
    return weights.fill_part(module, name)


def reference_block(run, weights: Weights, name: str,
                    variant: ref_kanana.Variant = ref_kanana.PUBLISHED,
                    precision: Optional[Precision] = None):
    """``(output, picks, bias change)`` of the reference's sparse block
    ``name`` with its first weights and biases on the recorded input, at
    ``precision`` (the stated one by default) and with ``variant``, its
    bias updated once."""
    block = _part(run, weights, name, lambda p: ref_kanana.SparseMoE(
        p["hidden_size"], p["n_routed_experts"], p["moe_intermediate_size"],
        p["num_experts_per_tok"],
        p["n_shared_experts"] * p["moe_intermediate_size"],
        float(p["routed_scaling_factor"])))
    x = run.stash["sparse"][name]["x"].to(run.device)
    prec = precision or stated(run.config)
    with torch.no_grad(), prec.active():
        y = block(x, prec, variant)
        chosen, _ = block.route(x, variant)
        start = block.expert_bias.clone()
        block.update_bias()
    return (y.cpu(), chosen.cpu(),
            (block.expert_bias - start).float().cpu())


def reference_mla(run, weights: Weights, name: str,
                  variant: ref_kanana.Variant = ref_kanana.PUBLISHED,
                  precision: Optional[Precision] = None) -> torch.Tensor:
    """The reference's MLA block ``name`` with its first weights on the
    recorded input, at ``precision`` (the stated one by default) and with
    ``variant``."""
    block = _part(run, weights, name, lambda p: ref_kanana.MLA(
        p["hidden_size"], p["num_attention_heads"], p["kv_lora_rank"],
        p["qk_nope_head_dim"], p["qk_rope_head_dim"], p["v_head_dim"],
        p["rms_norm_eps"], float(p["rope_theta"])))
    x = run.stash["mla"][name]["x"].to(run.device)
    prec = precision or stated(run.config)
    with torch.no_grad(), prec.active():
        return block(x, prec, variant).cpu()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def sparse_numbers(run, variant: Optional[ref_kanana.Variant] = None,
                   precision: Optional[Precision] = None
                   ) -> Dict[str, float]:
    """``enc_train_lfm2.sparse_numbers`` on this stack (each block's
    output with its shared experts): ``moe_out_gap``, ``pick_gap`` and
    ``bias_gap`` against the reference's block at the stated precision,
    the largest over the blocks. The side held is the program's first
    forward and update, or, with ``variant`` or ``precision``, the
    reference's block with that stand-in."""
    weights = Weights(run.config, run.seed, run.device, run.stash["start"])
    experts = encoder_params(run.config)["n_routed_experts"]
    out = {"moe_out_gap": 0.0, "pick_gap": 0.0, "bias_gap": 0.0}
    for name, rec in run.stash["sparse"].items():
        y_ref, chosen_ref, db_ref = reference_block(run, weights, name)
        if variant is None and precision is None:
            y, chosen = rec["y"], rec["chosen"]
            db = rec["bias"] - run.stash["start"][
                f"{name}.expert_bias"].float().cpu()
        else:
            y, chosen, db = reference_block(
                run, weights, name, variant or ref_kanana.PUBLISHED,
                precision)
        gaps = {"moe_out_gap": _rel(y, y_ref),
                "pick_gap": pick_share(chosen, chosen_ref, experts),
                "bias_gap": _rel(db, db_ref)}
        out = {k: max(out[k], gaps[k]) for k in out}
    return out


def mla_numbers(run, variant: Optional[ref_kanana.Variant] = None,
                precision: Optional[Precision] = None) -> Dict[str, float]:
    """``mla_out_gap``: ``||y - y_ref|| / ||y_ref||`` of each MLA block's
    output against the reference's MLA at the stated precision on the
    block's recorded input, the largest over the blocks. The side held is
    the program's first forward, or, with ``variant`` or ``precision``,
    the reference's block with that stand-in."""
    weights = Weights(run.config, run.seed, run.device, run.stash["start"])
    gap = 0.0
    for name, rec in run.stash["mla"].items():
        y_ref = reference_mla(run, weights, name)
        y = (rec["y"] if variant is None and precision is None
             else reference_mla(run, weights, name,
                                variant or ref_kanana.PUBLISHED, precision))
        gap = max(gap, _rel(y, y_ref))
    return {"mla_out_gap": gap}


def numbers(run, ref: compare.Summary) -> Dict[str, float]:
    out = compare.training_numbers(run.stash["prog"], ref)
    out.update(sparse_numbers(run))
    out.update(mla_numbers(run))
    return out


def check(run):
    run.stash["numbers"] = numbers(run, reference_summary(run))
    return compare.held(run.stash["numbers"], run.cell.limits)
