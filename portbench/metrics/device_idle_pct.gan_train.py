"""device_idle_pct.gan_train: the untraced window's idle share, from the
traced busy time per unit of work, in percent."""
from portbench.readers import untraced_idle_pct


def read(run):
    return untraced_idle_pct(run)
