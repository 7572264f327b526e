"""The synthesizer's CUDA-graph replay of the generator forward
(``ste_gan_torch/infer_graphs.py``, ``EMGSynthesizer``).

On the CPU (tier-1): the engagement rule (a CPU synthesizer, one with
replicas, a grad-mode call and a hooked generator run every call eagerly
and count it, with no capture; so does a call outside inference mode or
with a number among its arguments); the signature (rows, padded length,
valid lengths given or not, a moved parameter and TF32 make new keys, an
in-place ``set_params`` does not); and, with the device check passed and
the capture stood in by an eager call, the bookkeeping through
``convert_dataset`` (the least-recently-used bound is
``tests/test_torch_graph_keys.py``'s), and threads that call one
synthesizer at once through stand-in graphs that share their buffers as
the real ones do; ``convert_dataset``'s pipelined loop against a serial
loop of ``synthesize_padded`` calls from numpy and from tensors, bit for
bit, each result owning its memory; the benchmark's
``graph_replay_pct.synth`` and ``ahead_pct.synth`` readers.

On the card (marked ``card``; they skip without one): graphed against
eager at full width over four shapes, a short tail batch among them, bit
for bit; ``convert_dataset`` over a log-normal split, cold and warm,
against the serial loop bit for bit, with its counters (the pipeline's
among them); a
replay after ``set_params``; a returned tensor left alone by the next
call; the HTTP service's streams and micro-batches from several threads at
once against the eager answers. Eager references come from a synthesizer whose generator holds a
forward hook, which keeps every call eager. cuDNN runs deterministic
algorithms here. Run them on a machine with a card with

    python -m pytest tests/test_torch_infer_graphs.py --noconftest -q

(``--noconftest``: the suite's conftest loads JAX, which that machine
lacks; nothing here needs it).
"""
import threading
import time

import numpy as np
import pytest
import torch

from ste_gan_torch import infer, infer_graphs
from ste_gan_torch.infer import EMGSynthesizer, convert_dataset
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_torch.utils import profiling

COUNTERS = (infer_graphs.EAGER, infer_graphs.CAPTURES, infer_graphs.REPLAYS)
DIM = 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _counts(before) -> dict:
    got = profiling.since(before)
    return {name: int(got.get(name, (0, 0))[0]) for name in COUNTERS}


def _generator(channels: int = 32, seed: int = 0) -> EMGGeneratorGanTTS:
    torch.manual_seed(seed)
    return EMGGeneratorGanTTS(num_sessions=4, channels=channels)


def _batch(rows: int, length: int, seed: int):
    """Host numpy ``(feats, sessions, modes, valid)``: the last row is
    shorter than the rest by a third of the length."""
    rng = np.random.default_rng(seed)
    valid = np.full((rows,), length, np.int64)
    valid[-1] = max(1, length - length // 3)
    return (rng.normal(size=(rows, length, DIM)).astype(np.float32),
            rng.integers(0, 4, rows), np.zeros(rows, np.int64), valid)


def _split(n: int, seed: int):
    """``convert_dataset``'s items: log-normal lengths (median 100
    frames), sessions uniform, units N(0, 1)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(100), 0.5, n), 10, 400).astype(int)
    return [{"UTT_ID": f"u{i:03d}", "SESSION_ID": f"s{i % 4}",
             "SESSION_INDEX": i % 4, "SPEAKING_MODE_IDX": 0,
             "SPEECH_UNITS": rng.normal(size=(t, DIM)).astype(np.float32)}
            for i, t in enumerate(lengths)]


def _shapes_and_batches(split, bucket: int, rows: int):
    """The distinct (rows, padded length) shapes of the batches
    ``convert_dataset`` makes, and the batches."""
    per_bucket = {}
    for item in split:
        padded = -(-len(item["SPEECH_UNITS"]) // bucket) * bucket
        per_bucket[padded] = per_bucket.get(padded, 0) + 1
    return (sum(len({min(rows, n - s) for s in range(0, n, rows)})
                for n in per_bucket.values()),
            sum(-(-n // rows) for n in per_bucket.values()))


def _serial(synth, split, bucket: int, rows: int, tensors: bool = False):
    """What ``convert_dataset`` returns, by a plain serial loop: its
    batches, each ``synthesize_padded(...).cpu()`` before the next is
    packed, from numpy (the service's path) or CPU tensors. The EMG of
    each utterance, in dataset order."""
    order = sorted(range(len(split)),
                   key=lambda i: len(split[i]["SPEECH_UNITS"]))
    groups = {}
    for i in order:
        padded = -(-len(split[i]["SPEECH_UNITS"]) // bucket) * bucket
        groups.setdefault(padded, []).append(i)
    out = [None] * len(split)
    for padded, indices in groups.items():
        for start in range(0, len(indices), rows):
            chunk = indices[start:start + rows]
            valid = np.array([len(split[i]["SPEECH_UNITS"]) for i in chunk])
            feats = np.zeros((len(chunk), padded, DIM), np.float32)
            for row, i in enumerate(chunk):
                feats[row, : valid[row]] = split[i]["SPEECH_UNITS"]
            args = (feats, np.array([split[i]["SESSION_INDEX"] for i in chunk]),
                    np.array([split[i]["SPEAKING_MODE_IDX"] for i in chunk]),
                    valid)
            if tensors:
                args = tuple(torch.from_numpy(a) for a in args)
            emg = synth.synthesize_padded(*args).cpu().numpy()
            for row, i in enumerate(chunk):
                out[i] = emg[row, : 16 * valid[row]]
    return out


def _assert_own_memory(results) -> None:
    """Each result owns its memory, and no two share any."""
    emgs = [r["FAKE_EMG"] for r in results]
    assert all(e.flags.owndata for e in emgs)
    for a in range(len(emgs)):
        for b in range(a + 1, len(emgs)):
            assert not np.shares_memory(emgs[a], emgs[b]), (a, b)


class _EagerGraph:
    """Stands in for a capture on the CPU: runs the forward eagerly."""

    def __init__(self, module):
        self.module = module

    def run(self, args):
        return self.module(*args)


def _stand_in(monkeypatch, captured=None):
    """The device check passed and the capture stood in by an eager
    call; ``captured`` collects each capture's first argument's shape."""
    def capture(self, args, warm):
        if captured is not None:
            captured.append(tuple(args[0].shape))
        return _EagerGraph(self.module)

    monkeypatch.setattr(infer_graphs, "_on_cuda", lambda t: True)
    monkeypatch.setattr(infer_graphs.GraphedForward, "_capture", capture)
    monkeypatch.setattr(infer_graphs.GraphedForward, "_after_last",
                        lambda self, graph: None)


# ---------------------------------------------------------------------------
# CPU: the engagement rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["cpu", "replicas", "grad", "hook",
                                  "inner_hook", "global_hook"])
def test_stays_eager_and_counts(case, monkeypatch):
    """Each case runs every call eagerly, counted under
    ``synth/graph_eager`` alone, and computes what the plain generator
    does; all but the CPU one with the device check passed and no
    capture possible."""
    gen = _generator()
    want_gen = _generator()
    devices = ["cpu", "cpu"] if case == "replicas" else None
    synth = EMGSynthesizer(gen, bucket=64, device="cpu", devices=devices)
    if case == "hook":
        gen.register_forward_hook(lambda m, a, o: None)
    if case == "inner_hook":
        gen.gblocks[3].register_forward_pre_hook(lambda m, a: None)
    handle = (torch.nn.modules.module.register_module_forward_hook(
        lambda m, a, o: None) if case == "global_hook" else None)
    if case != "cpu":
        monkeypatch.setattr(infer_graphs, "_on_cuda", lambda t: True)
        monkeypatch.setattr(infer_graphs.GraphedForward, "_capture", None)
    feats, sess, mode, valid = _batch(3, 64, seed=1)
    before = profiling.counters()
    try:
        for _ in range(3):
            if case == "grad":
                # The wrapper alone: the synthesizer computes under
                # inference mode whatever its caller's grad mode.
                assert torch.is_grad_enabled()
                got = synth._graphed(torch.from_numpy(feats),
                                     torch.from_numpy(sess),
                                     torch.from_numpy(mode),
                                     torch.from_numpy(valid))
            else:
                got = synth.synthesize_padded(feats, sess, mode, valid)
    finally:
        if handle is not None:
            handle.remove()
    assert _counts(before) == {infer_graphs.EAGER: 3,
                               infer_graphs.CAPTURES: 0,
                               infer_graphs.REPLAYS: 0}
    assert synth._graphed._admission.entries == {}
    with torch.no_grad():
        want = want_gen.eval()(torch.from_numpy(feats),
                               torch.from_numpy(sess),
                               torch.from_numpy(mode),
                               num_valid_frames=torch.from_numpy(valid))
    # Replicas split the rows, which may change the CPU's blocking.
    tol = dict(rtol=1e-5, atol=1e-6) if case == "replicas" else dict(
        rtol=0, atol=0)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("arg, reason", [
    ([1, 2], "an argument neither a tensor nor None"),
    (5, "an argument neither a tensor nor None"),
    (None, "not on one CUDA device"),
    ("no_grad", "not in inference mode"),
])
def test_eager_reasons(arg, reason, monkeypatch):
    """A list or a number among the arguments, a call on the CPU or one under
    ``torch.no_grad()`` alone keeps the call eager; with none of the
    reasons, graphs may serve it."""
    call = infer_graphs.GraphedForward(torch.nn.Linear(4, 4))
    x = torch.zeros(2, 4)
    mode = torch.no_grad if arg == "no_grad" else torch.inference_mode
    args = (x, None if arg == "no_grad" else arg)
    with mode():
        assert call.eager_reason(args) == reason
        monkeypatch.setattr(infer_graphs, "_on_cuda", lambda t: True)
        want = None if arg is None else reason
        assert call.eager_reason(args) == want


def test_signature_keys(monkeypatch):
    """Rows, padded length, valid lengths given or not, a moved parameter
    and TF32 in cuDNN make new keys; the same call, other valid lengths,
    and weights copied in place by ``set_params`` keep it."""
    synth = EMGSynthesizer(_generator(), device="cpu")
    sig = synth._graphed.signature

    def call(rows=2, length=64, valid=None):
        return (torch.zeros(rows, length, DIM),
                torch.zeros(rows, dtype=torch.long),
                torch.zeros(rows, dtype=torch.long), valid)

    key = sig(call())
    assert sig(call()) == key
    valid = sig(call(valid=torch.full((2,), 40)))
    assert sig(call(valid=torch.full((2,), 17))) == valid
    others = [sig(call(rows=3)), sig(call(length=128)), valid]
    assert len({key, *others}) == 1 + len(others)
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cudnn, "allow_tf32",
                  not torch.backends.cudnn.allow_tf32)
        assert sig(call()) != key
    halved = {k: v * 0.5 for k, v in synth.generator.state_dict().items()}
    synth.set_params(halved)
    assert sig(call()) == key
    weight = next(synth.generator.parameters())
    weight.data = weight.data.clone()
    assert sig(call()) != key


def test_convert_dataset_bookkeeping(monkeypatch):
    """With the capture stood in: per shape the first call eager, the
    second captured, later ones served, over three passes; the answers
    are the plain synthesizer's."""
    captured = []
    _stand_in(monkeypatch, captured)
    split = _split(40, seed=2)
    shapes, batches = _shapes_and_batches(split, 64, 8)
    assert 3 <= shapes < batches
    synth = EMGSynthesizer(_generator(), device="cpu")
    before = profiling.counters()
    passes = [convert_dataset(synth, split, "SPEECH_UNITS", bucket=64,
                              max_batch=8) for _ in range(3)]
    assert _counts(before) == {infer_graphs.EAGER: shapes,
                               infer_graphs.CAPTURES: shapes,
                               infer_graphs.REPLAYS: 3 * batches - shapes}
    assert len(captured) == len(set(captured)) == shapes
    monkeypatch.undo()
    want = convert_dataset(EMGSynthesizer(_generator(), device="cpu"), split,
                           "SPEECH_UNITS", bucket=64, max_batch=8)
    for got in passes:
        for g, w in zip(got, want):
            assert g["UTT_ID"] == w["UTT_ID"]
            np.testing.assert_array_equal(g["FAKE_EMG"], w["FAKE_EMG"])


@pytest.mark.parametrize("inputs", ["numpy", "tensor"])
def test_convert_dataset_equals_a_serial_loop(inputs):
    """Over a log-normal split, ``convert_dataset`` (one batch in flight)
    returns in dataset order, bit for bit, what a serial loop of
    ``synthesize_padded`` calls returns, whether that loop passes numpy
    (the service's path) or tensors; every result owns its memory."""
    synth = EMGSynthesizer(_generator(), device="cpu")
    split = _split(40, seed=4)
    assert _shapes_and_batches(split, 64, 8)[1] >= 3
    want = _serial(synth, split, 64, 8, tensors=inputs == "tensor")
    got = convert_dataset(synth, split, "SPEECH_UNITS", bucket=64,
                          max_batch=8)
    assert [g["UTT_ID"] for g in got] == [item["UTT_ID"] for item in split]
    for g, w, item in zip(got, want, split):
        assert g["FAKE_EMG"].shape == (16 * len(item["SPEECH_UNITS"]), 8)
        np.testing.assert_array_equal(g["FAKE_EMG"], w)
    _assert_own_memory(got)


def test_warm_first():
    """A capture runs the forward outside the capture first at its
    thread's first capture, and where another thread ran the signature's
    eager call; not where this thread did, after its first capture."""
    call = infer_graphs.GraphedForward(torch.nn.Linear(4, 4))
    here = threading.get_ident()
    assert call._warm_first(here)
    assert not call._warm_first(here)
    assert call._warm_first(here + 1)
    got = []
    thread = threading.Thread(target=lambda: got.extend(
        [call._warm_first(here), call._warm_first(threading.get_ident())]))
    thread.start()
    thread.join()
    assert got == [True, False]


class _SharedBuffers:
    """Stands in for a capture on the CPU with the real one's hazards: a
    signature's calls share its input buffers, and the graphs of one
    synthesizer write one output buffer (their memory pool), which a call
    copies out after the next one could have started."""

    def __init__(self, module, pool: dict):
        self.module, self.pool, self.static = module, pool, None

    def run(self, args):
        if self.static is None:
            self.static = [a.clone() for a in args]
        for mine, a in zip(self.static, args):
            mine.copy_(a)
        time.sleep(1e-3)
        self.pool["out"] = self.module(*self.static)
        time.sleep(1e-3)
        return self.pool["out"].clone()


def test_threads_share_one_synthesizer(monkeypatch):
    """Four threads at once through one ``GraphedForward`` whose stand-in
    graphs share their buffers: every call returns its own input's answer,
    and each of the two signatures is eager once and captured once."""
    pool = {}
    _stand_in(monkeypatch)
    monkeypatch.setattr(infer_graphs.GraphedForward, "_capture",
                        lambda self, args, warm: _SharedBuffers(self.module,
                                                                pool))
    net = torch.nn.Linear(4, 4)
    call = infer_graphs.GraphedForward(net)
    gen = torch.Generator().manual_seed(0)
    inputs = {(t, i): torch.randn(1 + (t + i) % 2, 4, generator=gen)
              for t in range(4) for i in range(20)}
    got, errors = {}, []

    def work(t: int):
        try:
            with torch.inference_mode():
                for i in range(20):
                    got[t, i] = call(inputs[t, i])
        except Exception as exc:  # surfaced below
            errors.append(exc)

    before = profiling.counters()
    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert errors == []
    assert _counts(before) == {infer_graphs.EAGER: 2,
                               infer_graphs.CAPTURES: 2,
                               infer_graphs.REPLAYS: 78}
    with torch.no_grad():
        for k, x in inputs.items():
            torch.testing.assert_close(got[k], net(x), rtol=0, atol=0)


@pytest.mark.parametrize("counters, want", [
    ({infer_graphs.REPLAYS: (68.0, 68), infer_graphs.EAGER: (2.0, 2)},
     100 * 68 / 70),
    ({infer_graphs.REPLAYS: (70.0, 70)}, 100.0),
    ({infer_graphs.EAGER: (70.0, 70), "synth/batches": (70.0, 70)}, 0.0),
    ({"synth/batches": (70.0, 70)}, None),
    (None, None),
])
def test_graph_replay_pct_synth_reader(counters, want, monkeypatch):
    """The benchmark's ``graph_replay_pct.synth``: replays over the
    generator calls of the untraced stretch; nothing from a program
    without the counters or without the spans' module."""
    import types

    from portbench import phases, spec

    if counters is None:
        monkeypatch.setattr(phases, "program_profiling", lambda: None)
        stash = {}
    else:
        stash = {"phases.untraced": {"units": 70.0, "seconds": 1.0,
                                     "counters": counters}}
    run = types.SimpleNamespace(stash=stash, config={})
    got = spec.reader("graph_replay_pct.synth")(run)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("counters, want", [
    ({infer.AHEAD: (68.0, 68), infer.BEHIND: (1.0, 1)}, 100 * 68 / 69),
    ({infer.AHEAD: (69.0, 69)}, 100.0),
    ({infer.BEHIND: (69.0, 69), "synth/batches": (70.0, 70)}, 0.0),
    ({"synth/batches": (70.0, 70)}, None),
    (None, None),
])
def test_ahead_pct_synth_reader(counters, want, monkeypatch):
    """The benchmark's ``ahead_pct.synth``: batches queued ahead of the
    card over those counted in the untraced stretch; nothing from a
    program without the counters (the CPU's, or one before the pipeline)
    or without the spans' module."""
    import types

    from portbench import phases, spec

    if counters is None:
        monkeypatch.setattr(phases, "program_profiling", lambda: None)
        stash = {}
    else:
        stash = {"phases.untraced": {"units": 70.0, "seconds": 1.0,
                                     "counters": counters}}
    run = types.SimpleNamespace(stash=stash, config={})
    got = spec.reader("ahead_pct.synth")(run)
    assert got == (None if want is None else pytest.approx(want))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _pair(card, seed: int = 0):
    """A full-width synthesizer and its eager reference (a hooked
    generator) with the same weights."""
    gen = _generator(channels=768, seed=seed)
    ref_gen = _generator(channels=768, seed=seed)
    ref_gen.register_forward_hook(lambda m, a, o: None)
    return (EMGSynthesizer(gen, bucket=64, device=card),
            EMGSynthesizer(ref_gen, bucket=64, device=card))


@pytest.mark.card
def test_graphed_equals_eager_on_the_card(card, monkeypatch):
    """Four shapes, a short tail batch among them, three batches each: the
    first eager, the second captured, the third replayed; then a single
    utterance of 37 frames, bucketed to 64, three times, which replays the
    (1, 64) graph with its valid length in the graph's buffer. Every
    answer equals the eager one bit for bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    synth, ref = _pair(card)
    before = profiling.counters()
    for rows, length in ((16, 256), (16, 320), (3, 320), (1, 64)):
        for i in range(3):
            batch = _batch(rows, length, seed=10 * length + rows + i)
            got = synth.synthesize_padded(*batch).cpu()
            want = ref.synthesize_padded(*batch).cpu()
            assert got.shape == (rows, 16 * length, 8)
            assert torch.equal(got, want)
    utterance = np.random.default_rng(5).normal(size=(37, DIM)).astype(
        np.float32)
    for _ in range(3):
        np.testing.assert_array_equal(synth.synthesize(utterance, 1),
                                      ref.synthesize(utterance, 1))
    # The reference's 15 calls are all eager; the graphed synthesizer's
    # first call of each of 4 shapes.
    assert _counts(before) == {infer_graphs.EAGER: 4 + 15,
                               infer_graphs.CAPTURES: 4,
                               infer_graphs.REPLAYS: 8 + 3}


@pytest.mark.card
def test_convert_dataset_on_the_card(card, monkeypatch):
    """A log-normal split, three passes, the first cold: every pass
    equals a serial loop of the eager synthesizer's ``synthesize_padded``
    bit for bit, and owns its memory; the graph counters read eager =
    captures = shapes, replays for the rest; per pass, ``synth/ahead``
    plus ``synth/behind`` count the batches less one."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    synth, ref = _pair(card, seed=1)
    split = _split(120, seed=3)
    shapes, batches = _shapes_and_batches(split, 64, 16)
    want = _serial(ref, split, 64, 16)
    before = profiling.counters()
    passes = []
    for _ in range(3):
        start = profiling.counters()
        passes.append(convert_dataset(synth, split, "SPEECH_UNITS",
                                      bucket=64, max_batch=16))
        got = profiling.since(start)
        assert sum(got.get(name, (0, 0))[0]
                   for name in (infer.AHEAD, infer.BEHIND)) == batches - 1
    assert _counts(before) == {infer_graphs.EAGER: shapes,
                               infer_graphs.CAPTURES: shapes,
                               infer_graphs.REPLAYS: 3 * batches - shapes}
    for got in passes:
        for g, w, item in zip(got, want, split):
            assert g["FAKE_EMG"].shape == (16 * len(item["SPEECH_UNITS"]), 8)
            np.testing.assert_array_equal(g["FAKE_EMG"], w)
        _assert_own_memory(got)


@pytest.mark.card
def test_replay_after_set_params_and_kept_outputs(card, monkeypatch):
    """After ``set_params`` with other weights a replay returns the new
    weights' answer; a tensor returned by one call is unchanged by the
    next."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    synth, ref = _pair(card, seed=2)
    first, second = _batch(16, 192, seed=7), _batch(16, 192, seed=8)
    for _ in range(2):
        synth.synthesize_padded(*first)
    before = profiling.counters()
    out = synth.synthesize_padded(*first)
    kept = out.clone()
    other = synth.synthesize_padded(*second)
    assert _counts(before)[infer_graphs.REPLAYS] == 2
    assert torch.equal(out, kept)
    assert not torch.equal(out, other)
    assert torch.equal(out.cpu(), ref.synthesize_padded(*first).cpu())

    new = _generator(channels=768, seed=9).state_dict()
    synth.set_params(new)
    ref.set_params(new)
    before = profiling.counters()
    got = synth.synthesize_padded(*first).cpu()
    assert _counts(before)[infer_graphs.REPLAYS] == 1
    assert torch.equal(got, ref.synthesize_padded(*first).cpu())
    assert not torch.equal(got, kept.cpu())


@pytest.mark.card
def test_service_threads_on_the_card(card, monkeypatch):
    """Three streams (``/synthesize_stream``'s path, on the callers'
    threads) and three threads of micro-batched requests (``/synthesize``'s,
    on the batcher's worker) at once on one synthesizer, twice over: each
    stream equals the eager synthesizer's bit for bit (one window shape),
    each request its eager single-utterance answer to f32 reduction noise
    (TF32 off; another request's EMG would differ by the signal); graphs
    served calls meanwhile."""
    from ste_gan_torch.serve import SynthesisService

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    synth, ref = _pair(card, seed=4)
    service = SynthesisService(synth, {}, max_batch=4, max_wait_ms=2.0,
                               bucket=64)
    rng = np.random.default_rng(6)
    streams = [rng.normal(size=(t, DIM)).astype(np.float32)
               for t in (200, 260, 330)]
    requests = [[rng.normal(size=(t, DIM)).astype(np.float32)
                 for t in rng.integers(20, 300, 6)] for _ in range(3)]
    got, errors = {}, []

    def stream(i: int):
        for r in range(2):
            got["stream", i, r] = np.concatenate(list(
                service.synthesize_stream(streams[i], i)))

    def batched(i: int):
        for r in range(2):
            for j, feats in enumerate(requests[i]):
                got["batch", i, j, r] = service.synthesize(feats, j % 4)

    def guarded(fn, i):
        try:
            fn(i)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    before = profiling.counters()
    threads = [threading.Thread(target=guarded, args=(fn, i))
               for i in range(3) for fn in (stream, batched)]
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
    finally:
        service.batcher.close()
    assert errors == []
    counts = _counts(before)
    assert counts[infer_graphs.CAPTURES] >= 1
    assert counts[infer_graphs.REPLAYS] >= 6
    for i in range(3):
        want = np.concatenate(list(ref.synthesize_streaming(
            streams[i], i, chunk_frames=64)))
        for r in range(2):
            np.testing.assert_array_equal(got["stream", i, r], want)
        for j, feats in enumerate(requests[i]):
            want = ref.synthesize(feats, j % 4)
            scale = max(1.0, float(np.abs(want).max()))
            for r in range(2):
                np.testing.assert_allclose(got["batch", i, j, r], want,
                                           rtol=1e-3, atol=1e-4 * scale)
