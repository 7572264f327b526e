"""Encoder pre-training with LFM2-8B-A1B's block stack: the encoder
trainer's per-step path on ``EMGEncoderLFM2``.

As ``drivers/enc_train.py`` (the same corpus drawn from the seed on the
card, ``SizeAwareSampler`` behind ``Prefetcher``, the fold on the card,
the warm-up learning rate, ``make_encoder_train_step``), with these
differences:

* the program's encoder is ``EMGEncoderLFM2`` built by
  ``init_emg_encoder`` from the config file's ``program`` part with the
  architecture's published keys (the file's top level) laid over its
  parameters, and its weights come from :class:`Weights`, this driver's
  seeded weight maker (``weights.py`` knows only the reference's nets);
* the stack starts where the seeded routers load their experts evenly
  (:func:`balanced_start`: the input projection centred, the expert
  biases balanced over one batch), so the check steps route as a
  balanced router does: seeded weights alone send every frame's top 4 to
  the same 4 experts, since the front end's features share one large
  direction. Training under the published recipe collapses the routing
  again within ~60 steps, before the window;
* the reference is ``reference/lfm2.py``'s ``LFM2Encoder``, which follows
  the check steps from the same weights, shifts and utterances, biases
  updated after each;
* each sparse block's input, output and picks in the first step's
  forward, and its bias after that step, are kept, and the reference's
  sparse block at the configuration's stated precision is held to them
  on the same input (:func:`sparse_numbers`): the numbers the router and
  the expert products set on their own, free of the rounding upstream.

Every leaf is drawn from a generator of its own, seeded from the run's
seed and the leaf's name, so a leaf's first value can be drawn again
where it is needed (the change of each parameter over the check steps)
without a copy of the whole model.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import compare
from portbench.drivers import common, enc_train
from portbench.drivers.enc_train import (  # noqa: F401
    _stream_seed, traced, window)
from portbench.reference import lfm2 as ref_lfm2
from portbench.reference import nets as ref_nets
from portbench.reference import train as ref_train
from portbench.reference.precision import F32, Precision
from portbench.weights import seeded_state

#: The architecture's keys at the config file's top level that the
#: program's encoder takes as they are (LFM2-8B-A1B's ``config.json``).
ARCH_KEYS = ("hidden_size", "num_hidden_layers", "layer_types",
             "num_attention_heads", "num_key_value_heads",
             "intermediate_size", "moe_intermediate_size",
             "num_dense_layers", "num_experts", "num_experts_per_tok",
             "conv_L_cache", "conv_bias", "norm_eps", "rope_theta",
             "norm_topk_prob", "routed_scaling_factor", "use_expert_bias")
#: Standard deviation of every linear, conv and expert weight of the stack.
INIT_STD = 0.02
#: The front end's leaves: drawn as ``weights.py`` draws the published
#: encoder's.
FRONT = ("conv_blocks.", "w_raw_in.", "w_out.", "w_aux.")
#: Sign-rule passes of :func:`balanced_bias`; the step shrinks by
#: ``BALANCE_DECAY`` a pass from half the centred scores' spread.
BALANCE_STEPS = 300
BALANCE_DECAY = 0.98


def encoder_params(config: Dict) -> Dict:
    """``EMGEncoderLFM2``'s keyword arguments: the program part's
    parameters with the architecture's keys laid over them."""
    params = dict(config["program"]["emg_encoder"]["params"])
    params.update({k: config[k] for k in ARCH_KEYS})
    return params


def program_config(config: Dict):
    from ste_gan_torch.config import config_from_dict

    prog = dict(config["program"])
    prog["emg_encoder"] = dict(prog["emg_encoder"],
                               params=encoder_params(config))
    return config_from_dict(prog)


def reference_module(config: Dict) -> ref_lfm2.LFM2Encoder:
    """The reference encoder of ``config`` on the meta device."""
    channels = config["program"]["data"]["num_emg_channels"]
    with torch.device("meta"):
        return ref_lfm2.LFM2Encoder(**ref_lfm2.config_sizes(
            encoder_params(config), channels))


class Weights:
    """The seeded first value of every leaf of the encoder, by name: the
    front end's (convs, BatchNorms, the input projection and the heads) as
    ``weights.seeded_state`` draws them for the published encoder; in the
    stack, norms 1, expert biases 0, every other leaf N(0, ``INIT_STD``)
    from a generator seeded with the run's seed and the leaf's name; a
    leaf named in ``fixed`` (:func:`balanced_start`'s) takes that value."""

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

    def leaf(self, name: str) -> torch.Tensor:
        if name in self.fixed:
            return self.fixed[name].to(self.device).clone()
        if name.startswith(FRONT):
            return self.front[name]
        shape = self.shapes[name]
        if name.endswith("norm.weight"):
            return torch.ones(shape, device=self.device)
        if name.endswith("expert_bias"):
            return torch.zeros(shape, device=self.device)
        g = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + zlib.crc32(name.encode())) % (2 ** 63))
        return torch.empty(shape, device=self.device).normal_(
            0.0, INIT_STD, generator=g)

    def fill(self, module: torch.nn.Module) -> torch.nn.Module:
        """A meta-device ``module`` (the program's or the reference's)
        moved to the device with every leaf's first value."""
        module.to_empty(device=self.device)
        state = module.state_dict(keep_vars=True)
        if set(state) != set(self.shapes):
            raise KeyError("the module's leaves differ from the reference's: "
                           f"{sorted(set(state) ^ set(self.shapes))[:8]}")
        with torch.no_grad():
            for name, t in state.items():
                t.copy_(self.leaf(name))
        return module

    def fill_part(self, module: torch.nn.Module, prefix: str
                  ) -> torch.nn.Module:
        """A meta-device submodule ``module`` of the encoder, named
        ``prefix``, moved to the device with its leaves' first values."""
        module.to_empty(device=self.device)
        with torch.no_grad():
            for name, t in module.state_dict(keep_vars=True).items():
                t.copy_(self.leaf(f"{prefix}.{name}"))
        return module

    def change_norms(self, module) -> Dict[str, float]:
        """``||p - p_0||`` of each parameter of ``module``."""
        with torch.no_grad():
            vals = [(p.float() - self.leaf(n)).norm()
                    for n, p in module.named_parameters()]
        names = [n for n, _ in module.named_parameters()]
        return dict(zip(names, torch.stack(vals).cpu().tolist()))


def balanced_bias(scores: torch.Tensor, top_k: int) -> torch.Tensor:
    """The bias ``[E]`` under which each token's ``top_k`` of ``scores +
    bias`` (``scores [S, E]``) load the experts evenly: minus each
    expert's mean score, then ``BALANCE_STEPS`` passes of the sign rule
    ``b_e += step * sign(mean load - load_e)`` with a shrinking step."""
    experts = scores.shape[1]
    mean = scores.mean(dim=0)
    bias = -mean
    step = 0.5 * float((scores - mean).std())
    ones = torch.ones(scores.shape[0] * top_k, device=scores.device)
    for _ in range(BALANCE_STEPS):
        chosen = torch.topk(scores + bias, top_k, dim=-1).indices
        load = torch.zeros(experts, device=scores.device).scatter_add_(
            0, chosen.reshape(-1), ones)
        bias += step * torch.sign(load.mean() - load)
        step *= BALANCE_DECAY
    return bias


def balanced_start(config: Dict, seed: int, device, emg: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The leaves, by name, that start the stack with its routers
    balanced, from the EMG windows ``emg [W, L, 8]`` (one batch): the
    input projection's bias set so that its outputs' mean
    over the windows is 0 (the front end's ReLU features share one large
    direction, which would set every router's choice alike), then the
    expert biases under which each router loads its experts evenly. The
    f32 reference with the seeded leaves runs the windows in training
    mode; each sparse block's bias is set from its own scores just ahead
    of it (:func:`balanced_bias`), so each block sees the routing of the
    balanced blocks before it."""
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
               if isinstance(m, ref_lfm2.SparseMoE)]
    with torch.no_grad(), F32.active():
        enc(emg.float(), F32, train=True)
    for h in handles:
        h.remove()
    return out


class SparseRecord:
    """Each sparse block's input, output and picks in the model's first
    training forward (on the host), by the block's name; the biases after
    the first step are added by the caller."""

    def __init__(self, model: torch.nn.Module):
        from ste_gan_torch.models.moe import DroplessMoE

        self.blocks: Dict[str, Dict[str, torch.Tensor]] = {}
        self.handles = [m.register_forward_hook(self._hook(n))
                        for n, m in model.named_modules()
                        if isinstance(m, DroplessMoE)]

    def _hook(self, name):
        def hook(block, args, out):
            if name in self.blocks:
                return
            x = args[0].reshape(-1, args[0].shape[-1])
            with torch.no_grad():
                chosen, _ = block.route(x)
            self.blocks[name] = {
                "x": x.detach().float().cpu().clone(),
                "y": out.detach().reshape(x.shape).float().cpu().clone(),
                "chosen": chosen.cpu().clone()}
        return hook

    def close(self, model: torch.nn.Module) -> Dict[str, Dict]:
        """Stops listening; adds each block's bias after the first step."""
        for h in self.handles:
            h.remove()
        for name, m in model.named_modules():
            if name in self.blocks:
                self.blocks[name]["bias"] = (
                    m.expert_bias.detach().float().cpu().clone())
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
    sparse = SparseRecord(model)
    for i in range(keep):
        metrics, _ = one_step()
        losses.append({"loss": float(metrics["loss"])})
        if i == 0:
            vals = torch.stack([m.norm() for m in state.opt.exp_avg]) / b1
            grads["enc"] = dict(zip(names, vals.cpu().tolist()))
            run.stash["sparse"] = sparse.close(model)
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


def release(run) -> None:
    enc_train.release(run)


def reference_summary(run, precision: Precision = F32,
                      routing: ref_lfm2.Routing = ref_lfm2.PUBLISHED,
                      batches=None) -> compare.Summary:
    """The reference's check steps over the recorded batches from the
    run's seeded weights (the balanced biases among them) and shifts, in
    ``precision`` and with ``routing``."""
    weights = Weights(run.config, run.seed, run.device,
                      run.stash["start"])
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
        precision, run.stash["n_win"], routing)
    changes = {"enc": weights.change_norms(enc)}
    return compare.Summary(rec.losses, rec.grads, changes, rec.stats,
                           outputs=rec.outputs)


def stated(config: Dict) -> Precision:
    """The configuration's stated precision (its ``control`` file entry
    ``stated``: bf16 products, the front end's convs in TF32)."""
    from portbench.control import precision

    return precision(config["control"]["stated"])


def reference_block(run, weights: Weights, name: str,
                    routing: ref_lfm2.Routing = ref_lfm2.PUBLISHED):
    """``(output, picks, bias change)`` of the reference's sparse block
    ``name`` with its first weights and biases on the recorded input, at
    the stated precision and with ``routing``, its bias updated once."""
    rec = run.stash["sparse"][name]
    p = encoder_params(run.config)
    with torch.device("meta"):
        block = ref_lfm2.SparseMoE(p["hidden_size"], p["num_experts"],
                                   p["moe_intermediate_size"],
                                   p["num_experts_per_tok"])
    block = weights.fill_part(block, name)
    x = rec["x"].to(run.device)
    prec = stated(run.config)
    with torch.no_grad(), prec.active():
        y = block(x, prec, routing)
        chosen, _ = block.route(x, routing)
        start = block.expert_bias.clone()
        block.update_bias()
    return (y.cpu(), chosen.cpu(),
            (block.expert_bias - start).float().cpu())


def pick_share(a: torch.Tensor, b: torch.Tensor, experts: int) -> float:
    """The share of ``a``'s picks ``[S, k]`` (token, expert) that ``b``
    does not make."""
    def onehot(c):
        return torch.zeros(c.shape[0], experts).scatter_(1, c.long(), 1.0)
    return 1.0 - float((onehot(a) * onehot(b)).sum()) / a.numel()


def sparse_numbers(run, routing: Optional[ref_lfm2.Routing] = None
                   ) -> Dict[str, float]:
    """The sparse blocks against the reference's at the stated precision
    on each block's recorded input, the largest over the blocks:

    * ``moe_out_gap``: ``||y - y_ref|| / ||y_ref||`` of the block's output;
    * ``pick_gap``: the share of the (token, expert) picks the reference
      does not make;
    * ``bias_gap``: ``||db - db_ref|| / ||db_ref||`` of the bias's change
      by the first step's update (1 for a bias left unchanged).

    The side held is the program's first forward and first update, or,
    with ``routing``, the reference's block with that stand-in routing."""
    weights = Weights(run.config, run.seed, run.device,
                      run.stash["start"])
    experts = encoder_params(run.config)["num_experts"]
    out = {"moe_out_gap": 0.0, "pick_gap": 0.0, "bias_gap": 0.0}
    for name, rec in run.stash["sparse"].items():
        y_ref, chosen_ref, db_ref = reference_block(run, weights, name)
        if routing is None:
            y, chosen = rec["y"], rec["chosen"]
            db = rec["bias"] - run.stash["start"][
                f"{name}.expert_bias"].float().cpu()
        else:
            y, chosen, db = reference_block(run, weights, name, routing)
        gaps = {"moe_out_gap": float((y - y_ref).norm() / y_ref.norm()),
                "pick_gap": pick_share(chosen, chosen_ref, experts),
                "bias_gap": float((db - db_ref).norm()
                                  / db_ref.norm().clamp(min=1e-30))}
        out = {k: max(out[k], gaps[k]) for k in out}
    return out


def numbers(run, ref: compare.Summary) -> Dict[str, float]:
    out = compare.training_numbers(run.stash["prog"], ref)
    out.update(sparse_numbers(run))
    return out


def check(run):
    run.stash["numbers"] = numbers(run, reference_summary(run))
    return compare.held(run.stash["numbers"], run.cell.limits)
