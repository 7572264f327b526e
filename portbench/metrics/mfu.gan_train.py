"""mfu.gan_train: the GAN step's share of the bf16 peak."""
from portbench.readers import mfu


def read(run):
    return mfu(run, "gan_train_step")
