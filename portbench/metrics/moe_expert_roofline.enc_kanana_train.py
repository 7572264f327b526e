"""moe_expert_roofline.enc_kanana_train: the expert products' least time at
the bf16 peak (3 forward and 6 backward products of ``2 picks D F``, F
768) over the device time under the program's ``enc/moe/experts`` span,
forward and backward, in percent. A program without the span gives
None."""
from portbench.kanana_phases import moe_expert_roofline


def read(run):
    return moe_expert_roofline(run)
