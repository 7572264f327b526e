"""moe_load_imbalance.enc_kanana_train: ``moe/max_load * E / moe/picks``
over the untraced stretch, the most-loaded expert's picks over the mean (1
is even). A program without the counters gives None."""
from portbench.kanana_phases import load_imbalance


def read(run):
    return load_imbalance(run)
