"""Sustained load on the port's HTTP micro-batching server.

    python -m ste_gan_torch.serve_load [--run_dir RUN [--tag best] |
        --artifact GEN.pt2] [--clients 8] [--requests 50] [--frames 64]
        [--max_batch 8] [--max_wait_ms 5] [--out report.json] [--device cpu]

Counterpart of ``benchmarks/serve_load.py``. Starts the real server
(:func:`ste_gan_torch.serve.make_http_server`) on a free port, warms batch
sizes 1..``max_batch`` at the bucket, then lets N client threads send M
``/synthesize`` requests each of ``--frames``-frame utterances (numpy-seeded
features, session 0) and reports the clients' latency percentiles, the
server's ``/stats`` (p50/p95/p99 and batch occupancy over the load alone,
the warm-up excluded; rejections), 503s,
requests per second and seconds of EMG per second. Without ``--run_dir``
or ``--artifact`` it serves the full-width generator of ``Config()`` with
seeded weights. Writes the report to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from ste_gan_torch import constants as C


def npz_payload(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def post(port: int, path: str, body: bytes, timeout: float = 900.0) -> bytes:
    """POST ``body`` to ``http://127.0.0.1:<port><path>``; raises
    ``urllib.error.HTTPError`` on a non-2xx answer."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def drive(port: int, payloads: Sequence[bytes], requests: int,
          path: str = "/synthesize") -> Dict:
    """One client thread per payload, each POSTing it ``requests`` times
    in a row after a common start. Returns the completed requests'
    latencies (ms), the 503 count, other failures (as strings) and the
    wall seconds from the start to the last answer."""
    latencies: List[float] = []
    rejected: List[int] = []
    errors: List[str] = []
    lock = threading.Lock()
    barrier = threading.Barrier(len(payloads) + 1)

    def client(body: bytes) -> None:
        barrier.wait()
        for _ in range(requests):
            start = time.perf_counter()
            try:
                np.load(io.BytesIO(post(port, path, body)))
                with lock:
                    latencies.append((time.perf_counter() - start) * 1e3)
            except urllib.error.HTTPError as exc:
                with lock:
                    if exc.code == 503:
                        rejected.append(1)
                    else:
                        errors.append(f"HTTP {exc.code}: {exc.read()[:200]}")
                if exc.code == 503:
                    time.sleep(0.05)  # honour the backpressure
            except OSError as exc:
                with lock:
                    errors.append(f"{type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=client, args=(body,))
               for body in payloads]
    for t in threads:
        t.start()
    barrier.wait()
    start = time.perf_counter()
    for t in threads:
        t.join()
    return {"latencies_ms": latencies, "rejected_503": len(rejected),
            "errors": errors, "wall_s": time.perf_counter() - start}


def percentiles(values_ms: Sequence[float]) -> Dict:
    lat = np.asarray(values_ms, np.float64)
    if not len(lat):
        return {}
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "mean": float(lat.mean())}


def run_load(service, clients: int = 8, requests: int = 50,
             frames: int = 64) -> Dict:
    """Warm ``service`` at batch sizes 1..max_batch, serve it on a free
    port, drive ``clients`` x ``requests`` ``/synthesize`` calls of
    ``frames`` frames and report (module docstring)."""
    from ste_gan_torch.serve import make_http_server

    synth = service.synthesizer
    dim = synth.generator.speech_input_dim
    for b in range(1, service.batcher.max_batch + 1):
        service.warmup(num_frames=frames, batch_sizes=(b,))
    # The server's percentiles and occupancy cover the load alone.
    service.batcher.reset_windows()
    warm = service.batcher.stats_snapshot()
    server = make_http_server(service, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(0)
        payloads = [npz_payload(feats=rng.normal(size=(frames, dim))
                                .astype(np.float32), session=0)
                    for _ in range(clients)]
        load = drive(port, payloads, requests)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    stats = service.batcher.stats_snapshot()
    completed = len(load["latencies_ms"])
    wall = load["wall_s"]
    emg_s = completed * frames * synth.upsample / C.EMG_SAMPLE_RATE
    return {
        "clients": clients, "requests_per_client": requests,
        "frames_per_request": frames, "completed": completed,
        "rejected_503": load["rejected_503"], "errors": load["errors"],
        "wall_s": wall, "requests_per_s": completed / wall,
        "emg_seconds_per_s": emg_s / wall,
        "client_latency_ms": percentiles(load["latencies_ms"]),
        "server_stats": stats,
        "server_batches_under_load": stats["batches"] - warm["batches"],
        "device": (torch.cuda.get_device_name(0)
                   if synth.device.type == "cuda" else str(synth.device)),
    }


def main(argv=None) -> Dict:
    from ste_gan_torch.serve import SynthesisService

    ap = argparse.ArgumentParser(
        prog="python -m ste_gan_torch.serve_load", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--run_dir", type=Path, default=None)
    src.add_argument("--artifact", type=Path, default=None,
                     help="serving artifact: the checkpoint-free path")
    ap.add_argument("--tag", default="best")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--frames", type=int, default=64,
                    help="frames per request, also the bucket")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--device", type=str, default=None,
                    help="device to serve on (default cuda)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON report here")
    args = ap.parse_args(argv)

    opts = dict(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                bucket=args.frames, device=args.device)
    if args.artifact is not None:
        service = SynthesisService.from_artifact(args.artifact, **opts)
    elif args.run_dir is not None:
        service = SynthesisService.from_run_dir(args.run_dir, tag=args.tag,
                                                **opts)
    else:
        from ste_gan_torch.config import Config
        from ste_gan_torch.infer import EMGSynthesizer
        from ste_gan_torch.models.generator import init_emg_generator

        cfg = Config()
        dtype = torch.bfloat16 if cfg.train.mixed_precision else torch.float32
        gen = init_emg_generator(cfg, dtype,
                                 torch.Generator().manual_seed(0))
        service = SynthesisService(EMGSynthesizer(gen, device=args.device),
                                   {}, max_batch=args.max_batch,
                                   max_wait_ms=args.max_wait_ms,
                                   bucket=args.frames)
    try:
        report = run_load(service, args.clients, args.requests, args.frames)
    finally:
        service.close()
    report["source"] = dict(service._source) or {"mode": "seeded"}
    text = json.dumps(report, indent=2)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return report


if __name__ == "__main__":
    main()
