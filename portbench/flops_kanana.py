"""Counts the model FLOPs of a real EMG sample of the kanana encoder cell
and writes them into its config file under ``flops``.

    python3 -m portbench.flops_kanana

As ``flops_lfm2.py``: the reference (``reference/kanana.py``) runs one
training step over the fold's windows, forward and gradient, on the meta
device under ``flops.ClassCounter``, at the configuration's stated
precision (the products' operands bf16, the router and the front end's
convolutions f32), divided by the fold's capacity in samples. Each expert
is given an equal share of the picks (``S k / E`` rows), which leaves the
experts' total work as any routing gives it. The reference's attention
computes every ``q k`` pair of a window and masks the later ones, so the
count holds the full ``T x T`` products, as ``flops_lfm2.py``'s does.

* ``enc_kanana_train_sample``: one step's FLOPs by class over the fold's
  capacity in samples.
"""
from __future__ import annotations

import json
from typing import Dict

import torch

from portbench import flops
from portbench.drivers.enc_train_kanana import reference_module
from portbench.flops_lfm2 import STATED
from portbench.reference import kanana as ref_kanana
from portbench.reference import losses as L
from portbench.reference import nets
from portbench.spec import PKG


class _EvenRows(ref_kanana.SparseMoE):
    """The sparse block with every expert given ``S k / E`` of the picks."""

    def rows(self, chosen, e):
        share = chosen.numel() // self.w1.shape[0]
        idx = torch.zeros(share, dtype=torch.long, device=chosen.device)
        return idx, idx


def enc_kanana_sample(config: Dict, traffic: Dict) -> Dict[str, float]:
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
    with flops.ClassCounter() as counter:
        su, ph = enc(x, STATED, train=True)
        loss = L.unit_distance(units, su) + L.phoneme_ce(ph, phon)
        torch.autograd.grad(loss, list(enc.parameters()))
    return {k: v / (n_win * window) for k, v in counter.counts.items()}


def main() -> None:
    path = PKG / "configs" / "enc_kanana2_30b_a3b.json"
    with open(path) as fp:
        cfg = json.load(fp)
    with open(PKG / "traffic" / "enc_kanana_train_mixed.json") as fp:
        traffic = json.load(fp)
    cfg["flops"] = {"enc_kanana_train_sample": enc_kanana_sample(cfg,
                                                                 traffic)}
    with open(path, "w") as fp:
        json.dump(cfg, fp, indent=2)
        fp.write("\n")
    print(path.name, json.dumps(cfg["flops"]))


if __name__ == "__main__":
    main()
