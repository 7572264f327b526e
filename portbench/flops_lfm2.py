"""Counts the model FLOPs of a real EMG sample of the LFM2 encoder cell and
writes them into its config file under ``flops``.

    python3 -m portbench.flops_lfm2

As ``flops.py`` counts ``enc_train_sample``: the reference
(``reference/lfm2.py``) runs one training step over the fold's windows,
forward and gradient, on the meta device under ``flops.ClassCounter``
(the depthwise conv counted by its own formula), at
the configuration's stated precision (the products' operands bf16, the
router and the front end's convolutions f32), divided by the fold's
capacity in samples. The routing's picks are data, which the meta device
does not have: each expert is given an equal share of the picks (``S k /
E`` rows), which leaves the experts' total work, ``2 S k D F`` a product,
as any routing gives it.

* ``enc_lfm2_train_sample``: one step's FLOPs by class over the fold's
  capacity in samples.
"""
from __future__ import annotations

import json
from typing import Dict

import torch

from portbench import flops
from portbench.drivers.enc_train_lfm2 import reference_module
from portbench.reference import losses as L
from portbench.reference import lfm2 as ref_lfm2
from portbench.reference import nets
from portbench.reference.precision import Precision
from portbench.spec import PKG

#: The configuration's stated precision: bf16 products, the front end's
#: convolutions in TF32.
STATED = Precision(torch.float32, tf32=True,
                   products=Precision(torch.bfloat16))


class _Counter(flops.ClassCounter):
    """``flops.ClassCounter`` with the depthwise conv (one input channel a
    group) counted as ``2 B C T_out L`` a pass (forward, data gradient,
    weight gradient): ``torch.utils.flop_counter``'s formula for the
    gradient of a grouped convolution counts it as a dense one."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name in ("convolution", "convolution_backward"):
            fwd = name == "convolution"
            w, groups = (args[1], args[8]) if fwd else (args[2], args[9])
            if groups > 1 and w.shape[1] == 1:
                out = func(*args, **(kwargs or {}))
                x, y = (args[0], out) if fwd else (args[1], args[0])
                passes = 1 if fwd else sum(bool(m) for m in args[10][:2])
                cls = ("bf16" if x.dtype in (torch.bfloat16, torch.float16)
                       else "f32")
                self.counts[cls] += (2.0 * x.shape[0] * w.shape[0]
                                     * y.shape[-1] * w.shape[-1] * passes)
                return out
        return super().__torch_dispatch__(func, types, args, kwargs)


class _EvenRows(ref_lfm2.SparseMoE):
    """The sparse block with every expert given ``S k / E`` of the picks."""

    def rows(self, chosen, e):
        share = chosen.numel() // self.w1.shape[0]
        idx = torch.zeros(share, dtype=torch.long, device=chosen.device)
        return idx, idx


def enc_lfm2_sample(config: Dict, traffic: Dict) -> Dict[str, float]:
    window = 8 * int(config["train"]["seq_len"])
    n_win = -(-int(traffic["max_len"]) // window)
    enc = reference_module(config)
    for block in enc.sparse():
        block.__class__ = _EvenRows
    frames = window // 16
    x = flops._meta((n_win, window, config["program"]["data"][
        "num_emg_channels"]))
    units = flops._meta((n_win, frames, nets.UNIT_DIM))
    phon = torch.zeros((n_win, frames), dtype=torch.long, device="meta")
    with _Counter() as counter:
        su, ph = enc(x, STATED, train=True)
        loss = L.unit_distance(units, su) + L.phoneme_ce(ph, phon)
        torch.autograd.grad(loss, list(enc.parameters()))
    return {k: v / (n_win * window) for k, v in counter.counts.items()}


def main() -> None:
    path = PKG / "configs" / "enc_lfm2_8b_a1b.json"
    with open(path) as fp:
        cfg = json.load(fp)
    with open(PKG / "traffic" / "enc_lfm2_train_mixed.json") as fp:
        traffic = json.load(fp)
    cfg["flops"] = {"enc_lfm2_train_sample": enc_lfm2_sample(cfg, traffic)}
    with open(path, "w") as fp:
        json.dump(cfg, fp, indent=2)
        fp.write("\n")
    print(path.name, json.dumps(cfg["flops"]))


if __name__ == "__main__":
    main()
