"""optim_host_ms.gan_train: host milliseconds a GAN step in the program's
``adamw`` (both updates) and ``gan/ema`` spans."""
from portbench.phases import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "adamw", "gan/ema")
