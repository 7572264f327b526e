"""The port's serving layer (``ste_gan_torch/serve.py``,
``ste_gan_torch/serve_load.py``) on the CPU: the classes of the JAX
package's tests/test_serve.py that apply (micro-batcher, service, HTTP,
artifact service, decode endpoint, checkpoint decoder, hot reload), the
port's batcher against the JAX package's on the same carried weights, and
the reload guarantees: a rejected reload changes no served weight, and a
request served during a reload sees the old weights or the new, never a mix.

Weights are made by JAX from a seed and carried by ``ste_gan_torch.interop``;
inputs are numpy-seeded. Within the port, results are held to the direct
synthesizer at the JAX tests' 1e-5; between the packages at the model
tolerance of tests/test_model_parity.py (rtol 1e-3, atol 2e-5).
"""
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import export as texport
from ste_gan_torch import interop, serve, serve_load
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.infer import EMGSynthesizer
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_torch.serve import (EMGDecoderService, MicroBatcher,
                                 ServiceOverloadedError, SynthesisService,
                                 make_http_server)
from ste_gan_tpu import infer as jinfer
from ste_gan_tpu import serve as jserve
from ste_gan_tpu.models import emg_encoder as jenc
from ste_gan_tpu.models import generator as jgen

TOL = dict(rtol=1e-3, atol=2e-5)
ENC = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
           num_heads=4, dim_feedforward=64, dropout=0.0,
           relative_positional_distance=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_gen():
    jm = jgen.EMGGeneratorGanTTS(num_sessions=4, channels=32)
    ids = jnp.zeros((1,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 256)), ids,
                     ids)["params"]
    return jm, params


@pytest.fixture(scope="module")
def small_synth(jax_gen):
    tm = EMGGeneratorGanTTS(num_sessions=4, channels=32)
    interop.load_generator(tm, jax_gen[1], C.DataType.SPEECH_UNITS)
    return EMGSynthesizer(tm, device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _serve(service, decoder=None):
    server = make_http_server(service, host="127.0.0.1", port=0,
                              decoder=decoder)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def _stop(server):
    server.shutdown()
    server.server_close()


def _npz(**arrays) -> bytes:
    return serve_load.npz_payload(**arrays)


def _join(threads, timeout=120.0):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


class TestMicroBatcher:
    def test_single_request_matches_direct(self, small_synth, rng):
        batcher = MicroBatcher(small_synth, max_batch=4, max_wait_ms=1.0,
                               bucket=16)
        try:
            feats = rng.normal(size=(21, 256)).astype(np.float32)
            got = batcher.submit(feats, session_idx=2)
            want = small_synth.synthesize(feats, session_idx=2)
            assert got.shape == want.shape == (21 * 16, 8)
            np.testing.assert_allclose(got, want, atol=1e-5)
        finally:
            batcher.close()

    def test_concurrent_requests_coalesce_and_match(self, small_synth, rng):
        batcher = MicroBatcher(small_synth, max_batch=8, max_wait_ms=200.0,
                               bucket=16)
        try:
            lengths = [9, 17, 24, 31]
            reqs = [(rng.normal(size=(n, 256)).astype(np.float32), i)
                    for i, n in enumerate(lengths)]
            results = [None] * len(reqs)

            def run(i):
                results[i] = batcher.submit(*reqs[i])

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            _join(threads)
            for (feats, sess), got in zip(reqs, results):
                want = small_synth.synthesize(feats, session_idx=sess)
                assert got.shape == (len(feats) * 16, 8)
                np.testing.assert_allclose(got, want, atol=1e-5)
            stats = batcher.stats_snapshot()
            assert stats["requests"] == len(reqs)
            assert stats["max_batch_seen"] > 1, "no coalescing happened"
            assert stats["batches"] < len(reqs)
        finally:
            batcher.close()

    def test_results_equal_the_jax_batcher(self, small_synth, jax_gen, rng):
        """The same concurrent requests through the port's batcher and the
        JAX package's, on the same weights: each caller gets the same
        EMG."""
        jm, params = jax_gen
        lengths = [5, 16, 23, 40, 33]
        reqs = [(rng.normal(size=(n, 256)).astype(np.float32), i % 4)
                for i, n in enumerate(lengths)]
        results = {}
        for name, batcher in (
                ("port", MicroBatcher(small_synth, max_batch=4,
                                      max_wait_ms=100.0, bucket=16)),
                ("jax", jserve.MicroBatcher(jinfer.EMGSynthesizer(jm, params),
                                            max_batch=4, max_wait_ms=100.0,
                                            bucket=16))):
            out = [None] * len(reqs)

            def run(i, batcher=batcher, out=out):
                out[i] = np.asarray(batcher.submit(*reqs[i]))

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(reqs))]
            try:
                for t in threads:
                    t.start()
                _join(threads, timeout=300)
                assert batcher.stats_snapshot()["max_batch_seen"] > 1
            finally:
                batcher.close()
            results[name] = out
        for (feats, _), got, want in zip(reqs, results["port"],
                                         results["jax"]):
            assert got.shape == want.shape == (16 * len(feats), 8)
            np.testing.assert_allclose(got, want, **TOL)

    def test_error_propagates_to_caller(self, small_synth):
        batcher = MicroBatcher(small_synth, max_batch=2, max_wait_ms=1.0)
        try:
            with pytest.raises(RuntimeError):
                # Wrong feature width: the generator fails, the caller sees it.
                batcher.submit(np.zeros((4, 3), np.float32), 0)
        finally:
            batcher.close()

    def test_overload_rejects_with_backpressure(self, small_synth, rng):
        """A burst beyond the bounded queue raises ServiceOverloadedError
        and is counted; percentiles and occupancy are reported."""
        release = threading.Event()

        class SlowSynth:
            upsample = small_synth.upsample

            def synthesize_padded(self, *args):
                release.wait(30)
                return small_synth.synthesize_padded(*args)

        batcher = MicroBatcher(SlowSynth(), max_batch=2, max_wait_ms=200.0,
                               bucket=16, max_queue=2)
        feats = rng.normal(size=(8, 256)).astype(np.float32)
        errors, oks = [], []

        def run():
            try:
                oks.append(batcher.submit(feats, 0, timeout=60))
            except ServiceOverloadedError as exc:
                errors.append(exc)

        threads = [threading.Thread(target=run) for _ in range(8)]
        try:
            for t in threads:
                t.start()
                time.sleep(0.05)  # each enqueues (or is rejected) in turn
            release.set()
            _join(threads, timeout=60)
            assert errors, "no request was rejected despite a full queue"
            assert len(oks) + len(errors) == 8
            stats = batcher.stats_snapshot()
            assert stats["rejected"] == len(errors)
            assert stats["latency_ms_p99"] >= stats["latency_ms_p50"]
            assert stats["batch_occupancy_mean"] >= 1.0
        finally:
            release.set()
            batcher.close()


class TestService:
    def test_session_resolution_and_warmup(self, small_synth):
        service = SynthesisService(small_synth, {"sess_a": 0, "sess_b": 3},
                                   max_wait_ms=1.0, bucket=16)
        try:
            assert service.resolve_session("sess_b") == 3
            assert service.resolve_session(1) == 1
            with pytest.raises(KeyError):
                service.resolve_session("nope")
            service.warmup(num_frames=16, batch_sizes=(1, 2))
            assert service.batcher.stats_snapshot()["requests"] >= 3
        finally:
            service.close()

    @pytest.mark.parametrize("session, mode, shape", [
        (4, 0, (8, 256)), (-1, 0, (8, 256)), ("nope", 0, (8, 256)),
        (0, 3, (8, 256)), (0, -1, (8, 256)), (0, 0, (8, 3)),
        (0, 0, (0, 256)), (0, 0, (8,))])
    def test_bad_request_is_refused_before_queueing(self, session, mode,
                                                    shape):
        """A session or speaking mode outside the model's tables (on the
        card: a device-side assert that fails every later call), or feats
        of the wrong shape (which would fail the whole batch), is answered
        400 on both synthesis endpoints and never reaches the model."""
        gen = EMGGeneratorGanTTS(num_sessions=4, channels=32,
                                 use_speaking_mode_embedding=True,
                                 num_speaking_modes=3).eval()

        class Refusing:
            generator, upsample, calls = gen, 16, []

            def synthesize_padded(self, *args):
                self.calls.append(args)

            def synthesize_streaming(self, *args, **kwargs):
                self.calls.append(args)

        synth = Refusing()
        service = SynthesisService(synth, {"s0": 0}, max_wait_ms=1.0,
                                   bucket=16)
        server, port = _serve(service)
        try:
            feats = np.zeros(shape, np.float32)
            with pytest.raises(ValueError if session != "nope" else KeyError):
                service.synthesize(feats, session, mode)
            for path in ("/synthesize", "/synthesize_stream"):
                with pytest.raises(urllib.error.HTTPError) as err:
                    serve_load.post(port, path, _npz(feats=feats,
                                                     session=session,
                                                     mode=mode))
                assert err.value.code == 400
            time.sleep(0.05)
            assert synth.calls == []
            stats = service.batcher.stats_snapshot()
            assert stats["requests"] == 0 and stats["queue_depth"] == 0
        finally:
            _stop(server)
            service.close()

    def test_main_refuses_data_parallel(self, tmp_path, monkeypatch):
        """--data_parallel beyond the cards present, or with an artifact
        (a single-device program), raises before anything loads."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="only 1 card"):
            serve.main(["--run_dir", str(tmp_path), "--data_parallel", "2"])
        with pytest.raises(SystemExit, match="checkpoint mode"):
            serve.main(["--artifact", str(tmp_path / "g.pt2"),
                        "--data_parallel", "2", "--device", "cpu"])


class TestHTTP:
    def test_http_round_trip_and_stats(self, small_synth, rng):
        service = SynthesisService(small_synth, {"s0": 0}, max_wait_ms=1.0,
                                   bucket=16)
        server, port = _serve(service)
        try:
            feats = rng.normal(size=(19, 256)).astype(np.float32)
            emg = np.load(io.BytesIO(serve_load.post(
                port, "/synthesize", _npz(feats=feats, session="s0",
                                          mode=0))))
            np.testing.assert_allclose(emg, small_synth.synthesize(feats, 0),
                                       atol=1e-5)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
                assert json.loads(resp.read()) == {"ok": True}
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats", timeout=10) as resp:
                stats = json.loads(resp.read())
            assert stats["requests"] == 1 and stats["reloads"] == 0
        finally:
            _stop(server)
            service.close()

    def test_http_streaming_matches_full(self, small_synth, rng):
        """/synthesize_stream: 8-byte big-endian length frames of f32 EMG,
        ended by 0, reassemble to the full-utterance result."""
        service = SynthesisService(small_synth, {"s0": 0}, max_wait_ms=1.0,
                                   bucket=16)
        server, port = _serve(service)
        try:
            feats = rng.normal(size=(150, 256)).astype(np.float32)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/synthesize_stream",
                data=_npz(feats=feats, session=0), method="POST")
            chunks = []
            with urllib.request.urlopen(req, timeout=300) as resp:
                assert int(resp.headers["X-Emg-Channels"]) == 8
                while True:
                    n = int.from_bytes(resp.read(8), "big")
                    if n == 0:
                        break
                    chunks.append(np.frombuffer(resp.read(n), np.float32)
                                  .reshape(-1, 8))
            assert len(chunks) > 1, "expected several streamed chunks"
            got = np.concatenate(chunks)
            want = small_synth.synthesize(feats, session_idx=0)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-4)
        finally:
            _stop(server)
            service.close()

    def test_http_overload_answers_503(self, small_synth, rng):
        release = threading.Event()

        class SlowSynth:
            upsample = small_synth.upsample
            generator = small_synth.generator

            def synthesize_padded(self, *args):
                release.wait(30)
                return small_synth.synthesize_padded(*args)

        service = SynthesisService(SlowSynth(), {}, max_batch=1,
                                   max_wait_ms=1.0, bucket=16, max_queue=1)
        server, port = _serve(service)
        body = _npz(feats=rng.normal(size=(8, 256)).astype(np.float32))
        codes = []

        def run():
            try:
                serve_load.post(port, "/synthesize", body, timeout=60)
                codes.append(200)
            except urllib.error.HTTPError as exc:
                codes.append((exc.code, exc.headers["Retry-After"]))

        threads = [threading.Thread(target=run) for _ in range(4)]
        try:
            for t in threads:
                t.start()
                time.sleep(0.1)
            release.set()
            _join(threads, timeout=60)
            assert (503, "1") in codes and 200 in codes
        finally:
            release.set()
            _stop(server)
            service.close()


@pytest.fixture(scope="module")
def artifacts(small_synth, tmp_path_factory):
    """Serving artifacts of the weights and of the halved weights, with a
    session vocabulary beside them."""
    root = tmp_path_factory.mktemp("artifact")
    paths = {}
    for name, gen in (("a", small_synth.generator),
                      ("b", _generator_like(small_synth, 0.5))):
        path = root / f"generator-{name}-serving.pt2"
        texport.save_exported(texport.export_generator(gen, 256, True), path,
                              texport.generator_meta(gen, 256, True))
        paths[name] = path
    (root / "session_idx_to_id.json").write_text(
        json.dumps({"0": "sess_a", "1": "sess_b"}))
    return paths


def _generator_like(synth, scale: float) -> EMGGeneratorGanTTS:
    gen = EMGGeneratorGanTTS(num_sessions=4, channels=32)
    gen.load_state_dict({k: v * scale for k, v in
                         synth.generator.state_dict().items()})
    return gen.eval()


class TestArtifactService:
    """serve --artifact: the service runs from a serving artifact alone."""

    def test_artifact_requests_match_framework_and_stream_is_501(
            self, artifacts, small_synth, rng):
        service = SynthesisService.from_artifact(
            artifacts["a"], max_batch=4, max_wait_ms=1.0, bucket=16,
            device="cpu")
        server, port = _serve(service)
        try:
            feats = rng.normal(size=(11, 256)).astype(np.float32)
            got = service.synthesize(feats, "sess_b")
            want = small_synth.synthesize(feats, 1)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5)
            with pytest.raises(NotImplementedError):
                service.synthesize_stream(np.zeros((8, 256), np.float32), 0)
            with pytest.raises(urllib.error.HTTPError) as err:
                serve_load.post(port, "/synthesize_stream",
                                _npz(feats=feats, session=0))
            assert err.value.code == 501
            assert service._source["mode"] == "artifact"
        finally:
            _stop(server)
            service.close()

    def test_artifact_service_checks_the_meta_files_index_ranges(
            self, artifacts):
        """The artifact's meta file carries the session and speaking-mode
        ranges, so a request out of range is refused before the program."""
        service = SynthesisService.from_artifact(
            artifacts["a"], max_wait_ms=1.0, bucket=16, device="cpu")
        try:
            gen = service.synthesizer.generator
            assert (gen.num_sessions, gen.num_speaking_modes) == (4, None)
            with pytest.raises(ValueError, match="session index 4"):
                service.synthesize(np.zeros((8, 256), np.float32), 4)
            assert service.batcher.stats_snapshot()["requests"] == 0
        finally:
            service.close()


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    """The JAX encoder, the port's with the same weights, and its artifact."""
    jm = jenc.EMGEncoderTransformer(**ENC)
    variables = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(7), jnp.zeros((1, 16 * 9, 8)), train=False))()
    tm = EMGEncoderTransformer(**ENC)
    interop.load_encoder(tm, variables)
    path = tmp_path_factory.mktemp("dec") / "encoder.pt2"
    texport.save_exported(texport.export_emg_encoder(tm.eval(), 8), path,
                          {"min_frames": texport.encoder_min_frames(tm),
                           "num_emg_channels": 8})
    return jm, variables, tm, path


class TestDecodeEndpoint:
    def test_decode_http_round_trip(self, encoder, small_synth, rng):
        jm, variables, tm, path = encoder
        decoder = EMGDecoderService(path, bucket=16, device="cpu")
        assert decoder.min_frames == 9 and decoder.channels == 8
        service = SynthesisService(small_synth, {}, max_batch=2,
                                   max_wait_ms=1.0, bucket=16)
        server, port = _serve(service, decoder)
        try:
            emg = (rng.normal(size=(16 * 21 + 7, 8)) * 0.1).astype(np.float32)
            out = np.load(io.BytesIO(serve_load.post(port, "/decode",
                                                     _npz(emg=emg))))
            units, ph = out["units"], out["phoneme_logits"]
            assert units.shape == (21, 256) and ph.shape == (21, 48)
            # The same zero-padded input (21 frames -> the 32-frame bucket)
            # through the port's encoder and the JAX one.
            padded = np.zeros((1, 32 * 16, 8), np.float32)
            padded[0, : 21 * 16] = emg[: 21 * 16]
            with torch.no_grad():
                want = tm.eval()(torch.from_numpy(padded))
            jwant = jm.apply(variables, jnp.asarray(padded), train=False)
            for got, w, jw in zip((units, ph), want, jwant):
                np.testing.assert_allclose(got, w[0, :21].numpy(), atol=1e-5)
                np.testing.assert_allclose(got, np.asarray(jw[0, :21]), **TOL)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats", timeout=10) as resp:
                assert json.loads(resp.read())["decode"]["requests"] == 1
        finally:
            _stop(server)
            service.close()

    def test_decoder_at_max_concurrency_answers_503(self, encoder):
        decoder = EMGDecoderService(encoder[3], bucket=16, max_concurrent=1,
                                    device="cpu")
        assert decoder._slots.acquire(blocking=False)  # one decode running
        try:
            with pytest.raises(ServiceOverloadedError):
                decoder.decode(np.zeros((16 * 10, 8), np.float32))
            assert decoder.stats_snapshot()["rejected"] == 1
        finally:
            decoder._slots.release()


class TestCheckpointDecoder:
    def test_checkpoint_decoder_matches_model(self, encoder, tmp_path, rng):
        jm, variables, tm, _ = encoder
        torch.save(tm.state_dict(), tmp_path / "best_val_loss_model.pt")
        cfg = TConfig()
        cfg.emg_encoder.params = dict(ENC)
        service = EMGDecoderService.from_checkpoint(
            cfg, tmp_path / "best_val_loss_model.pt", bucket=8, device="cpu")
        assert service.channels == 8
        assert service.min_frames == 9  # relative-position distance + 1
        emg = (rng.normal(size=(16 * 24, 8)) * 0.1).astype(np.float32)
        units, ph = service.decode(emg)
        assert units.shape == (24, 256) and ph.shape == (24, 48)
        jwant = jm.apply(variables, jnp.asarray(emg)[None], train=False)
        np.testing.assert_allclose(units, np.asarray(jwant[0][0]), **TOL)
        np.testing.assert_allclose(ph, np.asarray(jwant[1][0]), **TOL)
        assert service.stats_snapshot()["requests"] == 1


class TestHotReload:
    """POST /reload: checkpoint mode checks keys and shapes, loads a new
    synthesizer and swaps it in; artifact mode warms the new program before
    the swap."""

    @staticmethod
    def _service(small_synth):
        service = SynthesisService(
            EMGSynthesizer(_generator_like(small_synth, 1.0), device="cpu"),
            {"s0": 0}, max_batch=4, max_wait_ms=1.0, bucket=16)
        service._source = {"mode": "run_dir", "run_dir": "unused",
                           "tag": "best"}
        return service

    @staticmethod
    def _weights(monkeypatch, state_dict):
        monkeypatch.setattr(serve, "load_served_generator",
                            lambda run_dir, tag, device: (None, None,
                                                          state_dict))

    def test_checkpoint_reload_swaps_weights(self, small_synth, rng,
                                             monkeypatch):
        service = self._service(small_synth)
        try:
            feats = rng.normal(size=(13, 256)).astype(np.float32)
            old = service.synthesizer
            before = service.synthesize(feats, 0)
            halved = _generator_like(small_synth, 0.5)
            self._weights(monkeypatch, halved.state_dict())
            info = service.reload(tag="checkpoint-00000003")
            assert info["reloaded"] and info["tag"] == "checkpoint-00000003"
            assert service.reload_count == 1 and service.synthesizer is not old
            after = service.synthesize(feats, 0)
            want = EMGSynthesizer(halved, device="cpu").synthesize(feats, 0)
            np.testing.assert_allclose(after, want, atol=1e-5)
            assert not np.allclose(before, after)
        finally:
            service.close()

    @pytest.mark.parametrize("bad", ["structure", "shapes"])
    def test_rejected_reload_changes_no_served_weight(self, small_synth,
                                                      monkeypatch, bad):
        """A state dict with other keys, or one tensor of another shape
        (every other tensor new and loadable), raises before anything is
        copied: the served weights stay bitwise the same."""
        service = self._service(small_synth)
        try:
            synth = service.synthesizer
            served = {k: v.clone() for k, v in
                      synth.generator.state_dict().items()}
            new = _generator_like(small_synth, 0.5).state_dict()
            if bad == "structure":
                new = {"not_the_same": torch.zeros(3)}
            else:
                new["gblocks.2.conv1.1.weight_v"] = torch.zeros(1, 2, 3)
            self._weights(monkeypatch, new)
            with pytest.raises(ValueError, match=bad):
                service.reload()
            assert service.synthesizer is synth
            assert service.reload_count == 0
            for key, value in synth.generator.state_dict().items():
                assert torch.equal(value, served[key]), key
        finally:
            service.close()

    def test_requests_during_a_reload_see_old_or_new_weights(
            self, small_synth, monkeypatch):
        """Clients (more threads than cores, a short switch interval) keep
        requesting while the weights are swapped: every answer equals the
        old model's output or the new one's, and none fails."""
        service = self._service(small_synth)
        halved = _generator_like(small_synth, 0.5)
        self._weights(monkeypatch, halved.state_dict())
        rng = np.random.default_rng(11)
        inputs = [rng.normal(size=(12 + i, 256)).astype(np.float32)
                  for i in range(12)]
        old = [small_synth.synthesize(f, 0) for f in inputs]
        new = [EMGSynthesizer(halved, device="cpu").synthesize(f, 0)
               for f in inputs]
        answers, errors = [], []
        lock = threading.Lock()

        def client(i):
            for _ in range(4):
                try:
                    got = service.synthesize(inputs[i], 0)
                except Exception as exc:  # noqa: BLE001 - counted below
                    with lock:
                        errors.append(exc)
                    continue
                with lock:
                    answers.append((i, got))

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(inputs))]
        try:
            for t in threads:
                t.start()
            time.sleep(0.05)
            service.reload()
            _join(threads, timeout=300)
        finally:
            sys.setswitchinterval(interval)
            service.close()
        assert not errors and len(answers) == 4 * len(inputs)
        seen = set()
        for i, got in answers:
            if np.allclose(got, old[i], atol=1e-5, rtol=0):
                seen.add("old")
            else:
                np.testing.assert_allclose(got, new[i], atol=1e-5, rtol=0)
                seen.add("new")
        assert "new" in seen

    def test_http_reload_endpoint_and_stats(self, small_synth, monkeypatch):
        service = self._service(small_synth)
        self._weights(monkeypatch, service.synthesizer.generator.state_dict())
        server, port = _serve(service)
        try:
            body = json.loads(serve_load.post(port, "/reload", b"{}"))
            assert body["reloaded"] and body["reloads"] == 1
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats", timeout=10) as resp:
                stats = json.loads(resp.read())
            assert stats["reloads"] == 1
            assert stats["model_source"]["mode"] == "run_dir"
        finally:
            _stop(server)
            service.close()

    def test_artifact_reload(self, artifacts, small_synth, rng):
        service = SynthesisService.from_artifact(artifacts["a"],
                                                 max_wait_ms=1.0, bucket=16,
                                                 device="cpu")
        try:
            feats = rng.normal(size=(10, 256)).astype(np.float32)
            before = service.synthesize(feats, 0)
            info = service.reload(artifact=str(artifacts["b"]))
            assert info["artifact"].endswith("generator-b-serving.pt2")
            after = service.synthesize(feats, 0)
            want = EMGSynthesizer(_generator_like(small_synth, 0.5),
                                  device="cpu").synthesize(feats, 0)
            np.testing.assert_allclose(after, want, atol=1e-5)
            assert not np.allclose(before, after)
            assert service.session_id_to_idx == {"sess_a": 0, "sess_b": 1}
        finally:
            service.close()


def test_load_driver_reports(small_synth):
    """``serve_load.run_load`` against the real server: every request
    answered, coalesced batches, the report's numbers consistent."""
    service = SynthesisService(small_synth, {}, max_batch=4, max_wait_ms=5.0,
                               bucket=16)
    try:
        report = serve_load.run_load(service, clients=4, requests=3,
                                     frames=16)
    finally:
        service.close()
    assert report["completed"] == 12 and not report["errors"]
    assert report["rejected_503"] == 0 and report["device"] == "cpu"
    # The server's occupancy covers the load alone, not the warm-up.
    stats = report["server_stats"]
    assert stats["batch_occupancy_max"] > 1
    assert stats["batch_occupancy_mean"] == pytest.approx(
        12 / report["server_batches_under_load"])
    lat = report["client_latency_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert report["emg_seconds_per_s"] == pytest.approx(
        report["requests_per_s"] * 16 * 16 / 800)
