"""launches_per_step.gan_train: kernels, copies and fills launched per
GAN step in the traced window."""
from portbench.readers import launches_per_unit


def read(run):
    return launches_per_unit(run)
