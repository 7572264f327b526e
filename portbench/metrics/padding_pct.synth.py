"""padding_pct.synth: the share of the frames synthesised that were
padding, from the program's ``synth/valid_frames`` and
``synth/computed_frames`` counters, in percent."""
from portbench.phases import padding_pct


def read(run):
    return padding_pct(run)
