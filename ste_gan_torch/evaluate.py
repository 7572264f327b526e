"""Offline evaluation CLI for the port's trained run directories.

    # the reference validation metrics of a trained GAN on a partition,
    # plus the full-utterance synthesis -> decode round trip:
    python -m ste_gan_torch.evaluate gan --run_dir exp/ste-gan/<run> \\
        --emg_enc_ckpt <enc_run>/best_val_loss_model.pt \\
        [--partition valid] [--tag best] [--full] [--realism] [--out FILE] \\
        [--device cpu]

    # the decode direction: encoder loss, phoneme accuracy and the labelled
    # confusion matrix on real EMG:
    python -m ste_gan_torch.evaluate encoder \\
        --ckpt <enc_run>/best_val_loss_model.pt --data_root data/synthetic \\
        [--partition valid] [--include_silent] [--out FILE] [--device cpu]

Counterpart of ``ste_gan_tpu/evaluate.py``, with its report keys and JSON
layout. ``gan`` scores first-chunk validation batches through the trainer's
eval step on the EMA weights; ``--full`` synthesises every utterance in f32
through the bucketed :class:`ste_gan_torch.infer.EMGSynthesizer`, decodes
the *generated* EMG with the frozen encoder and scores every frame;
``--realism`` adds the distribution-level metrics of
:mod:`ste_gan_torch.realism`. ``encoder`` runs the encoder trainer's eval
step; with ``--include_silent`` the silent utterances take the DTW-aligned
path (the ``dtw_align_kernel`` on a card).

Checkpoints are the port's own: a GAN run directory of
``ste_gan_torch.train.train_gan`` and the reference-layout encoder ``.pt``
of ``ste_gan_torch.train.encoder``. Runs on ``cuda`` unless ``--device``
says otherwise; without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import emg_encoder_constants as EC
from ste_gan_torch.device import resolve_device


def top_confusions(confusion: np.ndarray, k: int = 10) -> list:
    """Largest off-diagonal entries of a ``[pred, target]`` confusion
    matrix, labelled with the phoneme inventory."""
    conf = np.asarray(confusion).copy()
    np.fill_diagonal(conf, 0)
    flat = conf.ravel()
    order = np.argsort(flat)[::-1][:k]
    out = []
    for idx in order:
        if flat[idx] == 0:
            break
        pred, target = np.unravel_index(idx, conf.shape)
        out.append({
            "predicted": C.PHONEME_INVENTORY[int(pred)],
            "target": C.PHONEME_INVENTORY[int(target)],
            "count": int(flat[idx]),
        })
    return out


def _vocab_from_run_dir(run_dir: Path):
    """The session and speaking-mode vocabularies a training run wrote
    (``{id: index}`` each), which fix the embedding indices."""
    sess = json.loads((run_dir / "session_idx_to_id.json").read_text())
    mode = json.loads((run_dir / "speaking_mode_idx_to_id.json").read_text())
    return ({v: int(k) for k, v in sess.items()},
            {v: int(k) for k, v in mode.items()})


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


# ---------------------------------------------------------------------------
# GAN evaluation
# ---------------------------------------------------------------------------


def evaluate_gan_chunked(cfg, models, state, dataset) -> Dict[str, float]:
    """The reference validation protocol on one partition: first-chunk
    batches through ``train.gan.make_eval_step`` on the EMA weights
    (waveform, envelope, multi-TD, speech-unit and phoneme errors and the
    phone counters)."""
    from ste_gan_torch.data.loader import DataLoader
    from ste_gan_torch.train.gan import (eval_generator_params,
                                         make_eval_step, validate)

    loader = DataLoader(dataset, cfg.train.batch_size, "valid",
                        shuffle=False, emg_train_length=cfg.train.chunk_size,
                        hopsize=C.HOPSIZE)
    with eval_generator_params(models, state):
        out = validate(make_eval_step(cfg, models), loader,
                       _device_of(models.generator))
    out["num_batches"] = len(loader)
    return out


def evaluate_gan_full(cfg, models, state, dataset,
                      bucket_frames: int = 64) -> Dict:
    """Full-utterance round trip: synthesise each utterance in f32 through
    the bucketed synthesizer (EMA weights), decode the *generated* EMG with
    the frozen encoder (zero padded to a bucket multiple), and score
    against the true unit and phoneme tracks over every frame."""
    from ste_gan_torch.infer import EMGSynthesizer, round_up
    from ste_gan_torch.train.gan import eval_generator_state_dict

    dev = _device_of(models.generator)
    synth = EMGSynthesizer.from_config(
        cfg, eval_generator_state_dict(models, state), bucket=bucket_frames,
        device=dev)
    hop = C.HOPSIZE
    confusion = np.zeros((C.NUM_PHONEMES, C.NUM_PHONEMES), np.int64)
    total_frames = correct = 0
    su_l1_sum = 0.0
    per_utt = []
    feature_key = cfg.model.speech_feature_type
    for idx in range(len(dataset)):
        sample = dataset[idx]
        fake = synth.synthesize(np.asarray(sample[feature_key]),
                                int(sample[C.DataType.SESSION_INDEX]),
                                int(sample[C.DataType.SPEAKING_MODE_INDEX]))
        target_su = np.asarray(sample[C.DataType.SPEECH_UNITS])
        target_ph = np.asarray(sample[C.DataType.PHONEMES])
        frames = min(len(target_ph), fake.shape[0] // hop)
        pad_frames = round_up(frames, bucket_frames)
        emg = np.zeros((1, pad_frames * hop, fake.shape[1]), np.float32)
        emg[0, : frames * hop] = fake[: frames * hop]
        with torch.inference_mode():
            units, ph_logits = models.encoder(torch.from_numpy(emg).to(dev))
        units = units[0, :frames].cpu().numpy()
        pred_ph = ph_logits[0, :frames].argmax(-1).cpu().numpy()
        hits = pred_ph == target_ph[:frames]
        np.add.at(confusion, (pred_ph, target_ph[:frames]), 1)
        su_l1 = float(np.abs(units - target_su[:frames]).mean())
        correct += int(hits.sum())
        total_frames += frames
        su_l1_sum += su_l1 * frames
        per_utt.append({"utt": dataset.utt_ids[idx], "frames": frames,
                        "phoneme_accuracy": round(float(hits.mean()), 5),
                        "su_l1": round(su_l1, 5)})
    return {
        "num_utterances": len(per_utt),
        "total_frames": total_frames,
        "phoneme_accuracy": correct / max(total_frames, 1),
        "chance_accuracy": 1.0 / C.NUM_PHONEMES,
        "su_l1": su_l1_sum / max(total_frames, 1),
        "top_confusions": top_confusions(confusion),
        "confusion_labels": list(C.PHONEME_INVENTORY),
        "confusion": confusion.tolist(),
        "per_utterance": per_utt,
    }


def evaluate_gan(run_dir: Path, emg_enc_ckpt: Path, partition: str = "valid",
                 tag: str = "best", full: bool = False,
                 realism: bool = False, bucket_frames: int = 64,
                 device=None) -> Dict:
    """Load a trained GAN run of the port, with the frozen encoder of
    ``emg_enc_ckpt`` (a reference-layout ``.pt``, loaded strictly), and
    evaluate it on one partition."""
    from ste_gan_torch.data.dataset import EMGDataset
    from ste_gan_torch.train.gan import load_trained_state
    from ste_gan_torch.train.train_gan import load_frozen_encoder

    dev = resolve_device(device)
    run_dir = Path(run_dir)
    cfg, models, state = load_trained_state(run_dir, tag, device=dev)
    load_frozen_encoder(models, Path(emg_enc_ckpt))
    sess_vocab, mode_vocab = _vocab_from_run_dir(run_dir)

    def make_dataset(filter_by_length: bool) -> EMGDataset:
        return EMGDataset(
            Path(cfg.data.dataset_root), partition=partition,
            session_id_to_idx=sess_vocab, speaking_mode_id_to_idx=mode_vocab,
            only_include_voiced=True, filter_by_length=filter_by_length,
            train_emg_length=cfg.train.chunk_size, strict=cfg.data.strict)

    report: Dict = {
        "mode": "gan", "run_dir": str(run_dir), "tag": tag,
        "partition": partition, "emg_enc_ckpt": str(emg_enc_ckpt),
        "chunked": evaluate_gan_chunked(cfg, models, state,
                                        make_dataset(filter_by_length=True)),
    }
    if full:
        report["full_utterance"] = evaluate_gan_full(
            cfg, models, state, make_dataset(filter_by_length=False),
            bucket_frames)
    if realism:
        from ste_gan_torch.realism import realism_report

        report["realism"] = realism_report(
            cfg, models, state, make_dataset(filter_by_length=False),
            bucket_frames)
    return report


# ---------------------------------------------------------------------------
# Encoder evaluation (the decode direction)
# ---------------------------------------------------------------------------


def evaluate_encoder(ckpt: Path, data_root: Path,
                     emg_enc_cfg: Optional[str] = None,
                     partition: str = "valid",
                     include_silent: bool = False,
                     batch_size: int = EC.BATCH_SIZE, device=None) -> Dict:
    """Encoder loss, phoneme accuracy and labelled confusion matrix on real
    EMG of one partition, through the encoder trainer's eval step. With
    ``include_silent`` the silent utterances take the DTW-aligned loss, as
    in training's validation."""
    from ste_gan_torch.config import load_config
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.train.encoder import (evaluate, init_mixed_datasets,
                                             init_voiced_datasets,
                                             make_encoder_eval_step)
    from ste_gan_torch.train.encoder_data import windows_needed

    dev = resolve_device(device)
    cfg = load_config(emg_enc_cfg=emg_enc_cfg)
    init = init_mixed_datasets if include_silent else init_voiced_datasets
    trainset, devset, testset = init(Path(data_root))
    dataset = {"train": trainset, "valid": devset, "test": testset}[partition]
    if len(dataset) == 0:
        raise ValueError(f"partition {partition!r} at {data_root} is empty")

    model = init_emg_encoder(cfg, torch.float32)
    model.load_state_dict(torch.load(Path(ckpt), map_location="cpu",
                                     weights_only=True), strict=True)
    model = model.to(dev).eval()

    # Window budget: enough to fold the largest possible eval batch.
    lengths = sorted(dataset.emg_lengths, reverse=True)[:batch_size]
    n_win = max(1, windows_needed(lengths, EC.SEQ_LEN))
    max_samples = max(64, 2 * n_win, batch_size)
    eval_step = make_encoder_eval_step(model, max_samples)
    loss, acc, confusion = evaluate(eval_step, dataset, n_win, max_samples,
                                    dev, batch_size=batch_size)
    return {
        "mode": "encoder", "ckpt": str(ckpt), "partition": partition,
        "include_silent": include_silent,
        "num_utterances": len(dataset),
        "loss": float(loss),
        "phoneme_accuracy": float(acc),
        "chance_accuracy": 1.0 / C.NUM_PHONEMES,
        "top_confusions": top_confusions(confusion),
        "confusion_labels": list(C.PHONEME_INVENTORY),
        "confusion": np.asarray(confusion).tolist(),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _print_summary(report: Dict) -> None:
    slim = {k: v for k, v in report.items() if k != "confusion"}
    if "full_utterance" in slim:
        slim["full_utterance"] = {
            k: v for k, v in slim["full_utterance"].items()
            if k not in ("per_utterance", "confusion")}
    print(json.dumps(slim, indent=2))


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(
        prog="python -m ste_gan_torch.evaluate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("gan", help="evaluate a trained GAN run")
    g.add_argument("--run_dir", type=Path, required=True)
    g.add_argument("--emg_enc_ckpt", type=Path, required=True,
                   help="the frozen perceptual encoder, a reference-layout "
                        ".pt (the encoder trainer's best_val_loss_model.pt)")
    g.add_argument("--partition", default="valid",
                   choices=("train", "valid", "test"))
    g.add_argument("--tag", default="best",
                   help="checkpoint tag: best | latest | checkpoint-XXXXXXXX")
    g.add_argument("--full", action="store_true",
                   help="also run the full-utterance synthesis->decode "
                        "round trip (per-utterance metrics + confusion)")
    g.add_argument("--realism", action="store_true",
                   help="also compute the distribution-level realism "
                        "metrics (Fréchet encoder distance, pooled "
                        "TD-feature Wasserstein, log-spectral distance) "
                        "between real and generated EMG (realism.py)")
    g.add_argument("--bucket_frames", type=int, default=64)
    g.add_argument("--out", type=Path, default=None,
                   help="write the JSON report here "
                        "(default <run_dir>/eval_<partition>.json)")

    e = sub.add_parser("encoder", help="evaluate an EMG-encoder checkpoint")
    e.add_argument("--ckpt", type=Path, required=True,
                   help="a reference-layout encoder state dict (.pt)")
    e.add_argument("--data_root", type=Path, required=True)
    e.add_argument("--emg_enc_cfg", default=None,
                   help="encoder architecture YAML (default: the built-in "
                        "conv_transformer defaults)")
    e.add_argument("--partition", default="valid",
                   choices=("train", "valid", "test"))
    e.add_argument("--include_silent", action="store_true")
    e.add_argument("--batch_size", type=int, default=EC.BATCH_SIZE)
    e.add_argument("--out", type=Path, default=None)
    for p in (g, e):
        p.add_argument("--device", type=str, default=None,
                       help="device to evaluate on (default cuda; 'cpu' "
                            "runs the kernels' plain versions)")

    args = parser.parse_args(argv)
    if args.command == "gan":
        report = evaluate_gan(args.run_dir, args.emg_enc_ckpt,
                              partition=args.partition, tag=args.tag,
                              full=args.full, realism=args.realism,
                              bucket_frames=args.bucket_frames,
                              device=args.device)
        out = args.out or (args.run_dir / f"eval_{args.partition}.json")
    else:
        report = evaluate_encoder(args.ckpt, args.data_root,
                                  emg_enc_cfg=args.emg_enc_cfg,
                                  partition=args.partition,
                                  include_silent=args.include_silent,
                                  batch_size=args.batch_size,
                                  device=args.device)
        out = args.out or (args.ckpt.parent / f"eval_{args.partition}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    logging.info("report written to %s", out)
    _print_summary(report)
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
