"""mfu.synth: synthesis' share of the TF32 peak, per valid frame."""
from portbench.readers import mfu


def read(run):
    return mfu(run, "synth_frame")
