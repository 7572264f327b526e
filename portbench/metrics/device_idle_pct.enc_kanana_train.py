"""device_idle_pct.enc_kanana_train: the traced window less the device's
busy union, in percent."""
from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
