"""graph_replay_pct.gan_train: the share of the GAN step's generator and
encoder calls served by a CUDA-graph replay over the untraced stretch,
from the program's ``gan/graph_replays`` and ``gan/graph_eager``
counters, in percent. A program without them gives None."""
from portbench.phases import untraced


def read(run):
    u = untraced(run)
    if u is None:
        return None
    replays = u["counters"].get("gan/graph_replays", (0.0, 0))[0]
    eager = u["counters"].get("gan/graph_eager", (0.0, 0))[0]
    if replays + eager <= 0:
        return None
    return 100.0 * replays / (replays + eager)
