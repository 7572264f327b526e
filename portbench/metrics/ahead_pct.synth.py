"""ahead_pct.synth: the share of the synthesis batches after the first of
a pass that the host queued while the card still ran the batch before,
over the untraced stretch, from the program's ``synth/ahead`` and
``synth/behind`` counters, in percent. A program without them gives
None."""
from portbench.phases import untraced


def read(run):
    u = untraced(run)
    if u is None:
        return None
    ahead = u["counters"].get("synth/ahead", (0.0, 0))[0]
    behind = u["counters"].get("synth/behind", (0.0, 0))[0]
    if ahead + behind <= 0:
        return None
    return 100.0 * ahead / (ahead + behind)
