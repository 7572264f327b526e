"""mfu.enc_lfm2_train: the LFM2 encoder step's share of the peaks of its
classes, per real (unpadded) EMG sample."""
from portbench.readers import mfu


def read(run):
    return mfu(run, "enc_lfm2_train_sample")
