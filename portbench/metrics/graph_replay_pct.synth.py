"""graph_replay_pct.synth: the share of the synthesizer's generator calls
served by a CUDA-graph replay over the untraced stretch, from the
program's ``synth/graph_replays`` and ``synth/graph_eager`` counters, in
percent. A program without them gives None."""
from portbench.phases import untraced


def read(run):
    u = untraced(run)
    if u is None:
        return None
    replays = u["counters"].get("synth/graph_replays", (0.0, 0))[0]
    eager = u["counters"].get("synth/graph_eager", (0.0, 0))[0]
    if replays + eager <= 0:
        return None
    return 100.0 * replays / (replays + eager)
