"""g_update_host_ms.gan_train: host milliseconds a GAN step in the
program's ``gan/g_update`` span (G's losses through D and its backward)."""
from portbench.phases import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "gan/g_update")
