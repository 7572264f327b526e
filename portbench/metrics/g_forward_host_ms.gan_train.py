"""g_forward_host_ms.gan_train: host milliseconds a GAN step in the
program's ``gan/g_forward`` span (the generator's forward)."""
from portbench.phases import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "gan/g_forward")
