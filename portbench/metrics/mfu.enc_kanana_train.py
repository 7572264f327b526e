"""mfu.enc_kanana_train: the kanana encoder step's share of the peaks of
its classes, per real (unpadded) EMG sample."""
from portbench.readers import mfu


def read(run):
    return mfu(run, "enc_kanana_train_sample")
