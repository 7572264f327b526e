"""The admission policy the GAN step's and the synthesizer's CUDA-graph
replays share (``ste_gan_torch/utils/graph_keys.py``), on the CPU: through
both callers, with the device check passed and the capture stood in by an
eager call, a signature's first call eager, its second captured, later
ones served, new signatures where the key changes, and the least recently
used dropped past each caller's bound; the hook walk with and without a
module whose own forward hooks the caller runs; the ``tp`` attribute the
tensor-parallel check reads.
"""
import importlib
import pkgutil

import pytest
import torch

import ste_gan_torch
from ste_gan_torch import infer_graphs
from ste_gan_torch.ops.conv import WNConv
from ste_gan_torch.train import graphed
from ste_gan_torch.utils import profiling
from ste_gan_torch.utils.graph_keys import hooked


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = WNConv(4, 4, 3, padding=1)
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x):
        return self.lin(self.conv(x).transpose(1, 2))


class _EagerGraphs:
    """Stands in for a capture on the CPU: runs the forward eagerly."""

    def __init__(self, module):
        self.module = module

    def run(self, args):
        return self.module.forward(*args)


def _caller(name: str, net: torch.nn.Module, captured: list, monkeypatch):
    """The GAN step's or the synthesizer's wrapper of ``net``, its module
    of constants and the context its calls run in, with the device check
    passed and each capture recorded in ``captured`` and stood in."""
    if name == "step":
        monkeypatch.setattr(graphed, "_on_cuda", lambda t: True)
        monkeypatch.setattr(graphed, "_Graphs", lambda module, args: (
            captured.append(args[0].shape[-1]) or _EagerGraphs(module)))
        return graphed.GraphedCall(net), graphed, torch.enable_grad

    def capture(self, args, warm):
        captured.append(args[0].shape[-1])
        return _EagerGraphs(self.module)

    monkeypatch.setattr(infer_graphs, "_on_cuda", lambda t: True)
    monkeypatch.setattr(infer_graphs.GraphedForward, "_capture", capture)
    monkeypatch.setattr(infer_graphs.GraphedForward, "_after_last",
                        lambda self, graph: None)
    return (infer_graphs.GraphedForward(net), infer_graphs,
            torch.inference_mode)


@pytest.mark.parametrize("name", ["step", "synth"])
def test_signatures_are_keyed_and_bounded(name, monkeypatch):
    """Shapes and a moved parameter make new signatures (for the step,
    ``requires_grad`` of a parameter too), each eager at its first call,
    captured at its second and served after; past the caller's
    ``MAX_SIGNATURES`` the least recently used goes and runs eagerly
    again, while a kept one seen once is captured."""
    net, captured = _Net(), []
    call, consts, mode = _caller(name, net, captured, monkeypatch)
    counters = (consts.EAGER, consts.CAPTURES, consts.REPLAYS)

    def served(length: int) -> bool:
        before = profiling.counters()
        with mode():
            out = call(torch.ones(2, 4, length))
        assert out.shape == (2, length, 4)
        got = profiling.since(before)
        counts = [int(got.get(c, (0, 0))[0]) for c in counters]
        assert counts[0] + counts[2] == 1
        return counts[2] == 1

    assert [served(5) for _ in range(3)] == [False, True, True]
    assert [served(7), served(7), served(5)] == [False, True, True]
    with torch.no_grad():
        net.lin.weight.data = net.lin.weight.data.clone()
    assert [served(5), served(5)] == [False, True]
    if name == "step":
        net.lin.bias.requires_grad_(False)
        assert [served(5), served(5)] == [False, True]
        net.lin.bias.requires_grad_(True)
    bound = consts.MAX_SIGNATURES
    assert not any(served(length) for length in range(10, 10 + bound))
    assert len(call._admission.entries) == bound
    # Seen once, so captured now; 10 is then the most recently used and
    # one more signature drops 11.
    assert served(10)
    assert not served(10 + bound)
    assert len(call._admission.entries) == bound
    assert [served(12), served(11), served(11)] == [True, False, True]
    assert captured == [5, 7, 5] + [5] * (name == "step") + [10, 12, 11]


@pytest.mark.parametrize("where, with_own, without_own", [
    ("none", False, False),
    ("own_forward", False, True),
    ("own_pre", True, True),
    ("inner_forward", True, True),
    ("inner_backward", True, True),
    ("global", True, True),
])
def test_hook_walk(where, with_own, without_own):
    """A hook a replay would skip: any hook, where the caller runs no
    module's forward hooks itself (synthesis); any but the given module's
    own forward hooks, where it runs those (the GAN step)."""
    net = _Net()
    handle = None
    if where == "own_forward":
        handle = net.register_forward_hook(lambda m, a, o: None)
    if where == "own_pre":
        handle = net.register_forward_pre_hook(lambda m, a: None)
    if where == "inner_forward":
        handle = net.lin.register_forward_hook(lambda m, a, o: None)
    if where == "inner_backward":
        handle = net.conv.register_full_backward_hook(lambda m, gi, go: None)
    if where == "global":
        handle = torch.nn.modules.module.register_module_forward_hook(
            lambda m, a, o: None)
    subs = list(net.modules())
    try:
        assert hooked(subs, net) == with_own
        assert hooked(subs) == without_own
    finally:
        if handle is not None:
            handle.remove()


def test_tp_is_set_on_instances_only():
    """The tensor-parallel check reads ``tp`` from a module's own
    attributes; that agrees with ``getattr`` on every module the port
    builds: no module class of the port or of torch holds a ``tp`` but
    None, and a shard set on a layer lands among its own attributes."""
    for info in pkgutil.walk_packages(ste_gan_torch.__path__,
                                      "ste_gan_torch."):
        importlib.import_module(info.name)
    classes, todo = set(), [torch.nn.Module]
    while todo:
        cls = todo.pop()
        classes.add(cls)
        todo.extend(set(cls.__subclasses__()) - classes)
    assert len(classes) > 100
    assert [c for c in classes if getattr(c, "tp", None) is not None] == []
    from ste_gan_torch.parallel.tensor_parallel import ModelShard

    conv = WNConv(4, 4, 3)
    conv.tp = ModelShard(None, 0, 1, None, conv.groups)
    assert vars(conv)["tp"] is getattr(conv, "tp")
    assert not isinstance(conv.tp, (torch.nn.Module, torch.Tensor))
