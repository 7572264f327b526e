"""mla_roofline.enc_kanana_train: the least time of multi-head latent
attention's norm, RoPE and causal core at the published 192/128 widths
(the larger of its operations at the bf16 peak and its bytes at the HBM
rate) over the device time under the program's ``enc/mla/attention``
span, forward and backward, in percent. A program without the span gives
None."""
from portbench.kanana_phases import mla_roofline


def read(run):
    return mla_roofline(run)
