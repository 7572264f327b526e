"""short_conv_roofline.enc_lfm2_train: the gated short conv's least time by
its bytes (``22 N D`` at 2 bytes a value a conv layer and step) over the
device time under the program's ``enc/lfm2/short_conv`` span, forward and
backward, in percent. A program without the span gives None."""
from portbench.lfm2_phases import short_conv_roofline


def read(run):
    return short_conv_roofline(run)
