"""Counts the model FLOPs per unit of work of each configuration and writes
them into its config file under ``flops``.

    python3 -m portbench.flops

The reference runs once at each cell's shapes on the meta device (no
data, no memory) under a dispatch mode that sums, per operation, the
FLOPs of ``torch.utils.flop_counter``'s formulas (convolutions and their
gradients, matrix products), and files them by the class they run in on
the card: bf16 operands in ``bf16``; f32 convolutions in ``tf32`` (cuDNN
runs them in TF32 by PyTorch's default) and f32 products in ``f32``
(cuBLAS TF32 is off by default). The reference casts operands where the
program does, so a bf16 program's work counts as bf16.

* ``gan_train_step``: one GAN step (the generator forward, the
  discriminator's loss and gradient on the detached fake, the generator's
  losses through the discriminator and the frozen encoder and its
  gradient); AdamW and the EMA add no products.
* ``enc_train_sample``: one encoder step over the fold's windows, forward
  and gradient, divided by the fold's capacity in samples, so that padding
  is not counted.
* ``synth_frame``: one generator forward over ``FRAMES`` input frames,
  divided by them.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from portbench.drivers import common
from portbench.reference import losses as L
from portbench.reference import nets
from portbench.reference.precision import Precision
from portbench.spec import PKG

CONV_OPS = ("convolution", "_convolution", "convolution_backward",
            "cudnn_convolution", "convolution_overrideable")
FRAMES = 200


class ClassCounter(TorchDispatchMode):
    """Sums the FLOPs of every counted operation by operation class."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
            if dtype in (torch.bfloat16, torch.float16):
                cls = "bf16"
            elif packet.__name__ in CONV_OPS:
                cls = "tf32"
            else:
                cls = "f32"
            self.counts[cls] += float(flops)
        return out


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def gan_step(config: Dict) -> Dict[str, float]:
    b, chunk = common.batch_shape(config)
    kw = common.sizes(config)
    with torch.device("meta"):
        gen = nets.Generator(**kw["g"])
        disc = nets.Discriminator(**kw["d"])
        enc = nets.Encoder(**kw["e"])
    enc.requires_grad_(False)
    p = Precision(torch.bfloat16)
    frames = chunk // 16
    feats = _meta((b, frames, nets.UNIT_DIM))
    sess = torch.zeros(b, dtype=torch.long, device="meta")
    real = _meta((b, chunk, kw["g"]["out_ch"]))
    units = _meta((b, frames, nets.UNIT_DIM))
    phon = torch.zeros((b, frames), dtype=torch.long, device="meta")
    with ClassCounter() as counter:
        fake = gen(feats, sess, p)
        fm_f, fm_r = disc(fake.detach(), real, p)
        torch.autograd.grad(L.d_loss(fm_f, fm_r), list(disc.parameters()))
        disc.requires_grad_(False)
        fm_f, fm_r = disc(fake, real, p)
        su, ph = enc(fake, p)
        loss = (L.g_adversarial(fm_f) + L.multi_td(real, fake)
                + L.unit_distance(units, su) + L.phoneme_ce(ph, phon)
                + L.feature_matching(fm_f, fm_r))
        torch.autograd.grad(loss, list(gen.parameters()))
    return dict(counter.counts)


def enc_sample(config: Dict, traffic: Dict) -> Dict[str, float]:
    window = 8 * int(config["train"]["seq_len"])
    n_win = -(-int(traffic["max_len"]) // window)
    kw = common.sizes(config)["e"]
    with torch.device("meta"):
        enc = nets.Encoder(**kw)
    frames = window // 16
    x = _meta((n_win, window, kw["num_ins"]))
    units = _meta((n_win, frames, nets.UNIT_DIM))
    phon = torch.zeros((n_win, frames), dtype=torch.long, device="meta")
    with ClassCounter() as counter:
        su, ph = enc(x, Precision(), train=True)
        loss = L.unit_distance(units, su) + L.phoneme_ce(ph, phon)
        torch.autograd.grad(loss, list(enc.parameters()))
    return {k: v / (n_win * window) for k, v in counter.counts.items()}


def synth_frame(config: Dict) -> Dict[str, float]:
    with torch.device("meta"):
        gen = nets.Generator(**common.sizes(config)["g"])
    gen.requires_grad_(False)
    with ClassCounter() as counter:
        gen(_meta((1, FRAMES, nets.UNIT_DIM)),
            torch.zeros(1, dtype=torch.long, device="meta"), Precision())
    return {k: v / FRAMES for k, v in counter.counts.items()}


def _load(path: Path) -> Dict:
    with open(path) as fp:
        return json.load(fp)


def main() -> None:
    su_path = PKG / "configs" / "ste_gan_su.json"
    enc_path = PKG / "configs" / "emg_encoder.json"
    su, enc = _load(su_path), _load(enc_path)
    su["flops"] = {"gan_train_step": gan_step(su),
                   "synth_frame": synth_frame(su)}
    enc["flops"] = {"enc_train_sample": enc_sample(
        enc, _load(PKG / "traffic" / "enc_train_mixed.json"))}
    for path, cfg in ((su_path, su), (enc_path, enc)):
        with open(path, "w") as fp:
            json.dump(cfg, fp, indent=2)
            fp.write("\n")
        print(path.name, json.dumps(cfg["flops"]))


if __name__ == "__main__":
    main()
