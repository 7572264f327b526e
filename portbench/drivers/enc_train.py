"""Encoder pre-training: the encoder trainer's per-step path.

Set-up builds the program's encoder (the configuration's class, the seeded
weights loaded strictly, f32 as the encoder trainer builds it), its train
state (``train.encoder.init_train_state``: AdamW, the shift and dropout
streams seeded from the run's seed) and the step from
``make_encoder_train_step``, and a corpus on the card drawn from the seed
in the layout of ``train.encoder_data.EncoderDeviceCorpus`` (flat f16
tracks): lengths spread evenly over the mix's range, a share of the
utterances silent with targets of their own length (a ratio spread evenly
over the mix's range). Batches come from ``SizeAwareSampler`` under the
sample budget, behind ``Prefetcher``; each step folds its batch on the
card, sets the warm-up learning rate and steps, as the trainer does.

The first ``check_steps`` steps go through that same feed and step (the
first one's unit and phoneme predictions kept as the step's own forward
returns them); the reference follows them from the same weights, the
same shifts and the same dropout stream, over the same utterances.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import compare
from portbench.drivers import common
from portbench.reference import nets
from portbench.reference import train as ref_train
from portbench.reference.precision import F32, Precision


def _stream_seed(run) -> int:
    return int(run.seed) % (2 ** 63)


def corpus_layout(run):
    """Host lengths of the corpus drawn from the seed: EMG samples,
    target frames and the silent flags."""
    t = run.traffic
    n = int(t["corpus_utterances"])
    order = common.rng(run.seed, common.ORDER)
    frames = order.permutation(common.spread_lengths(n, t["frames_min"],
                                                     t["frames_max"]))
    silent = np.zeros(n, bool)
    silent[order.permutation(n)[:int(round(n * t["silent_fraction"]))]] = True
    lo, hi = t["silent_target_ratio"]
    ratio = order.permutation(np.linspace(lo, hi, n))
    targets = np.where(silent, np.maximum(1, np.round(frames * ratio)),
                       frames).astype(np.int64)
    return 16 * frames, targets, silent


def make_corpus(run):
    """The corpus on the card, in ``EncoderDeviceCorpus``'s layout."""
    from ste_gan_torch.train.encoder_data import EncoderDeviceCorpus

    emg_lens, fr_lens, silent = corpus_layout(run)
    dev = run.device
    g = common.torch_gen(run.seed, common.DATA, dev)
    f16 = torch.float16
    max_t = int(fr_lens.max())
    n_fr = int(fr_lens.sum()) + max_t
    corpus = EncoderDeviceCorpus.__new__(EncoderDeviceCorpus)
    corpus.emg_ratio = 16
    corpus.max_target_frames = max_t
    corpus.emg_flat = torch.tanh(0.4 * torch.randn(
        (int(emg_lens.sum()), 8), generator=g, device=dev, dtype=f16))
    su = torch.randn((n_fr, nets.UNIT_DIM), generator=g,
                     device=dev, dtype=f16)
    su[-max_t:] = 0
    ph = torch.randint(0, nets.PHONEMES, (n_fr,),
                       generator=g, device=dev, dtype=torch.int32)
    ph[-max_t:] = 0
    corpus.su_flat, corpus.ph_flat = su, ph

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    corpus.emg_start = put(np.concatenate([[0], np.cumsum(emg_lens)[:-1]]))
    corpus.emg_len = put(emg_lens)
    corpus.fr_start = put(np.concatenate([[0], np.cumsum(fr_lens)[:-1]]))
    corpus.fr_len = put(fr_lens)
    corpus.silent_flag = put(silent)
    return corpus, emg_lens, fr_lens, silent


def setup(run) -> None:
    from ste_gan_torch.data.loader import Prefetcher, to_device
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.ops.fused_adamw import set_learning_rate
    from ste_gan_torch.train import encoder as tenc
    from ste_gan_torch.train.encoder_data import SizeAwareSampler

    cfg = common.program_config(run)
    t = run.traffic
    states = common.seeded_weights(run.config, "e", run.seed, run.device)
    with torch.device("meta"):
        model = init_emg_encoder(cfg, torch.float32, torch.Generator())
    common.materialise(model, states.pop("e"), run.device)
    run.mark("program")
    corpus, emg_lens, fr_lens, silent = make_corpus(run)
    run.mark("corpus")

    max_len = int(t["max_len"])
    window_len = 8 * int(run.config["train"]["seq_len"])
    n_win = max(1, -(-max_len // window_len))
    max_samples = max(64, 2 * n_win, 16)
    sil = np.flatnonzero(silent)
    dims = {}
    if len(sil):
        dims = {"max_silent": int(min(len(sil),
                                      max_len // int(emg_lens[sil].min()) + 1)),
                "silent_target_frames": int(fr_lens[sil].max())}
        silent_pred_frames = int((emg_lens[sil] // 16).max())
    else:
        silent_pred_frames = 0
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
    before = {"enc": {n: p.detach().clone()
                      for n, p in model.named_parameters()}}
    losses, grads = [], {}
    b1 = float(np.float32(1) - np.float32(run.config["train"]["b1"]))
    first = compare.FirstOutputs(model, ("units", "phonemes"))
    for i in range(keep):
        metrics, _ = one_step()
        losses.append({"loss": float(metrics["loss"])})
        if i == 0:
            vals = torch.stack([m.norm() for m in state.opt.exp_avg]) / b1
            grads["enc"] = dict(zip(names, vals.cpu().tolist()))
    run.stash["prog"] = compare.Summary(
        losses, grads,
        compare.change_norms({"enc": dict(model.named_parameters())}, before),
        compare.running_vars(model), outputs=first.outputs)
    del before
    run.mark("first steps")
    for _ in range(int(t["warmup_steps"])):
        one_step()
    pending.clear()
    run.mark("warm-up")
    run.stash.update(model=model, feed=feed, one_step=one_step,
                     corpus=corpus, drawn=drawn, n_win=n_win,
                     lens=(emg_lens, fr_lens, silent), pending=pending)


def window(run) -> Dict[str, float]:
    import time

    one_step = run.stash["one_step"]
    run.sync()
    t0 = time.perf_counter()
    n, real = 0, 0
    while True:
        _, r = one_step()
        n += 1
        real += r
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    seconds = time.perf_counter() - t0
    # The configuration's products are f32 with TF32 off: 1 where the
    # program switched cuBLAS to TF32 (or lower) by the window's close.
    run.stash["tf32_matmul"] = float(
        torch.get_float32_matmul_precision() != "highest")
    run.window = {"units": real, "seconds": seconds, "attempted": n,
                  "failed": 0}
    return {"enc_train_samples_per_s": real / seconds}


def traced(run) -> float:
    n = int(run.traffic["trace_steps"])
    for _ in range(n):
        run.stash["one_step"]()
    return n


def release(run) -> None:
    run.stash.pop("feed").close()
    for key in ("model", "one_step", "pending"):
        run.stash.pop(key)


def reference_batches(run) -> List[List[ref_train.Utterance]]:
    corpus = run.stash["corpus"]
    emg_lens, fr_lens, silent = run.stash["lens"]
    emg_start = np.concatenate([[0], np.cumsum(emg_lens)[:-1]])
    fr_start = np.concatenate([[0], np.cumsum(fr_lens)[:-1]])
    out = []
    for rows in run.stash["drawn"]:
        utts = []
        for r in rows:
            e0, f0 = int(emg_start[r]), int(fr_start[r])
            utts.append(ref_train.Utterance(
                emg=corpus.emg_flat[e0:e0 + int(emg_lens[r])],
                units=corpus.su_flat[f0:f0 + int(fr_lens[r])],
                phonemes=corpus.ph_flat[f0:f0 + int(fr_lens[r])],
                silent=bool(silent[r])))
        out.append(utts)
    return out


def reference_summary(run, precision: Precision = F32,
                      batches=None) -> compare.Summary:
    """The reference's first steps over the recorded batches, from the
    run's seeded weights, shifts and dropout stream, in ``precision``."""
    nets_, states = common.reference_nets(run.config, "e", run.seed,
                                          run.device)
    batches = batches or reference_batches(run)
    shifts = np.random.default_rng(_stream_seed(run))
    tr = run.config["train"]
    dropout_rate = run.config["program"]["emg_encoder"]["params"]["dropout"]
    lrs = [min(i + 1, tr["warmup_steps"]) * tr["lr"] / tr["warmup_steps"]
           for i in range(len(batches))]
    dropout = torch.Generator(device=run.device).manual_seed(
        _stream_seed(run))
    rec = ref_train.encoder_steps(
        nets_["e"], batches, [int(shifts.integers(0, 8)) for _ in batches],
        dropout, ref_train.EncHyper(lrs=lrs, b1=tr["b1"], b2=tr["b2"],
                                    wd=tr["wd"], dropout=dropout_rate),
        precision, run.stash["n_win"])
    changes = compare.change_norms(rec.params, {"enc": states["e"]})
    return compare.Summary(rec.losses, rec.grads, changes, rec.stats,
                           outputs=rec.outputs)


def check(run):
    numbers = compare.training_numbers(run.stash["prog"],
                                       reference_summary(run))
    numbers["tf32_matmul"] = run.stash["tf32_matmul"]
    run.stash["numbers"] = numbers
    return compare.held(numbers, run.cell.limits)
