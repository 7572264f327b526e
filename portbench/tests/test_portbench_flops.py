"""The FLOP count: by hand on small products, and the configs' numbers
equal to a fresh count."""
import json

import pytest
import torch
import torch.nn.functional as F

from portbench import flops
from portbench.spec import PKG


def test_counts_by_class_by_hand():
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 16), device="meta")
    x = torch.empty((2, 3, 10), device="meta", dtype=torch.bfloat16)
    w = torch.empty((6, 3, 5), device="meta", dtype=torch.bfloat16)
    with flops.ClassCounter() as c:
        a @ b
        F.conv1d(x, w)
        F.conv1d(x.float(), w.float())
    assert c.counts["f32"] == 2 * 4 * 8 * 16
    conv = 2 * 2 * 6 * 6 * 3 * 5    # 2 B T_out C_out C_in K
    assert c.counts["bf16"] == conv
    assert c.counts["tf32"] == conv


def test_configs_hold_a_fresh_count():
    su = json.loads((PKG / "configs" / "ste_gan_su.json").read_text())
    enc = json.loads((PKG / "configs" / "emg_encoder.json").read_text())
    traffic = json.loads((PKG / "traffic" / "enc_train_mixed.json")
                         .read_text())
    assert su["flops"]["gan_train_step"] == pytest.approx(flops.gan_step(su))
    assert su["flops"]["synth_frame"] == pytest.approx(flops.synth_frame(su))
    assert enc["flops"]["enc_train_sample"] == pytest.approx(
        flops.enc_sample(enc, traffic))
