"""d_update_host_ms.gan_train: host milliseconds a GAN step in the
program's ``gan/d_update`` span (D's paired forward, loss and gradients)."""
from portbench.phases import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "gan/d_update")
