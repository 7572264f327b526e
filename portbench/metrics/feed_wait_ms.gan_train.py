"""feed_wait_ms.gan_train: milliseconds a GAN step the host waits for the
prefetch queue (the program's ``feed/wait`` span)."""
from portbench.phases import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "feed/wait")
