#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of ``ste_gan_torch/csrc`` (one ``nvcc`` per source, in parallel)
   and print each compiled kernel's registers and spills (``ptxas -v``);
2. each kernel, through the wrapper the main path calls (``conv_fwd``,
   ``conv_dx``, ``conv_dw``, ``fused_adamw_``), against its plain PyTorch
   version on the card, at the shapes of the main path: the grouped conv's
   forward (bf16: ``conv_fwd_bf16_kernel``), dX and dW at all six (layer,
   scale) geometries of the small scale discriminators on the paired
   2B = 64 batch, in f32 (TF32 off) and bf16; forward, dX and dW also at
   the edge geometries of ``tests/test_torch_grouped_conv.py`` (strides
   1/2/4, groups 1-16, down to 2 input and 4 output channels per group, 128
   output channels per group, odd lengths) and one with K < stride, in both
   types; two bf16 dW calls must agree bit for bit; AdamW over
   generator- and discriminator-size parameter sets for 3 steps. Kernel,
   plain and library times come from CUDA events; the bound is the larger of
   bytes over 3.35 TB/s and operations over the peak rate for the operand
   type;
3. a small-input reference: two f32 train steps of a narrow configuration
   through the CUDA kernels agree with the same steps on the CPU (the
   kernels' plain versions);
4. the main path at full width (``ste_gan_torch.train.gan.main_path``):
   ``Config()`` (batch 32 x 2048 samples, the 768-channel generator, the
   small discriminator ensemble, the full encoder, all five loss families,
   bf16 compute) with ``generator_ema=0.999``, seeded random weights and a
   numpy-seeded synthetic batch; 3 warm-up and 10 timed steps; every loss finite. Each
   kernel's launch count is set to 0 just before and read just after, and
   must be above 0;
5. the ``kernels`` JSON line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no CUDA device is present or when
run outside a checkout of the repository. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # max |kernel - plain| / max |plain|
#: Small scale discriminator grouped layers: (Cin, Cout, K, stride, groups, pad).
GROUPED_LAYERS = ((128, 256, 37, 2, 4, 18), (256, 512, 37, 2, 16, 18))
PAIRED_BATCH = 64
CHUNK = 2048
#: Edge geometries (B, T, Cin, Cout, K, stride, pad, groups): the CASES of
#: tests/test_torch_grouped_conv.py, then K < stride (a phase without taps).
EDGE_GEOMETRIES = ((2, 64, 16, 32, 15, 1, 7, 1), (2, 64, 32, 64, 9, 2, 4, 4),
                   (2, 64, 32, 64, 9, 2, 4, 16), (2, 64, 32, 64, 9, 4, 4, 8),
                   (1, 50, 16, 16, 5, 2, 2, 4), (2, 64, 32, 256, 5, 1, 2, 2),
                   (2, 33, 8, 16, 3, 4, 1, 2))


def cuda_time(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_summary(log: str):
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its name
    and template integers, registers and shared memory, stack and spills."""
    lines, name, spill = [], "?", ""
    for ln in log.splitlines():
        entry = re.search(r"entry function '(\S+)'", ln)
        if entry:
            # The kernel's name ends in "_kernel" and is prefixed by its
            # length in the mangled name.
            mangled = name = entry.group(1)
            spill = ""
            end = mangled.find("_kernel") + len("_kernel")
            for start in range(end - len("_kernel"), 0, -1):
                n = str(end - start)
                if mangled[max(0, start - len(n)):start] == n:
                    name = mangled[start:end]
                    break
            ints = re.findall(r"Li(\d+)E", mangled)
            if ints:
                name += f"<{','.join(ints)}>"
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}")
    return lines


def check_grouped_conv(torch, gc, F):
    """Forward, dX and dW at the six main-path geometries, f32 and bf16."""
    rows, summary = [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for layer, (cin, cout, k, s, g, pad) in enumerate(GROUPED_LAYERS, 1):
        for scale in range(3):
            t_in = (CHUNK >> scale) // (1 if layer == 1 else 2)
            t_out = gc.out_length(t_in, k, s, pad, pad)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                x = torch.randn(PAIRED_BATCH, cin, t_in, device="cuda",
                                generator=gen).to(dtype)
                w = (torch.randn(cout, cin // g, k, device="cuda",
                                 generator=gen)
                     / (k * cin / g) ** 0.5).to(dtype)
                dy = torch.randn(PAIRED_BATCH, cout, t_out, device="cuda",
                                 generator=gen).to(dtype)
                item = x.element_size()
                ops = 2.0 * PAIRED_BATCH * t_out * cout * k * (cin // g)
                xb, wb, yb = x.numel() * item, w.numel() * item, dy.numel() * item

                def conv_lib(x=x, w=w):
                    return F.conv1d(x, w, stride=s, padding=pad, groups=g)

                def grad_lib(mask, x=x, w=w, dy=dy):
                    return torch.ops.aten.convolution_backward(
                        dy, x, w, None, [s], [pad], [1], False, [0], g, mask)

                cases = {
                    "grouped_conv_fwd": (
                        lambda: gc.conv_fwd(x, w, s, pad, pad, g),
                        lambda: gc.conv_fwd_plain(x, w, s, pad, pad, g),
                        conv_lib, xb + wb + yb),
                    "grouped_conv_dx": (
                        lambda: gc.conv_dx(dy, w, s, pad, t_in, g),
                        lambda: gc.conv_dx_plain(dy, w, s, pad, t_in, g),
                        lambda: grad_lib([True, False, False])[0],
                        yb + wb + xb),
                    "grouped_conv_dw": (
                        lambda: gc.conv_dw(x, dy, k, s, pad, pad, g),
                        lambda: gc.conv_dw_plain(x, dy, k, s, pad, pad, g),
                        lambda: grad_lib([False, True, False])[1],
                        xb + yb + wb),
                }
                for name, (kern, plain, lib, nbytes) in cases.items():
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ref = want.float().abs().max().item()
                    rel = err / max(ref, 1e-30)
                    ok = rel <= TOL[dname]
                    row = {"kernel": name, "layer": layer, "scale": scale,
                           "dtype": dname, "max_abs_err": err,
                           "max_rel_err": rel, "tol": TOL[dname], "ok": ok}
                    if dtype == torch.bfloat16:
                        b_ms, b_by = bound_ms(nbytes, ops, dname)
                        row.update(ms=cuda_time(kern), plain_ms=cuda_time(plain),
                                   library_ms=cuda_time(lib), bound_ms=b_ms,
                                   bound_by=b_by)
                        agg = summary.setdefault(name, {
                            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                            "library_ms": 0.0, "bound_ms": 0.0,
                            "bound_by": b_by})
                        agg["max_abs_err"] = max(agg["max_abs_err"], err)
                        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                            agg[key] += row[key]
                    rows.append(row)
                    print(f"[conv] {name} layer{layer} scale{scale} {dname}: "
                          f"max|err| {err:.3e} rel {rel:.3e} (tol "
                          f"{TOL[dname]:g}) "
                          + (f"kernel {row['ms']:.4f} ms plain "
                             f"{row['plain_ms']:.4f} ms library "
                             f"{row['library_ms']:.4f} ms bound "
                             f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                             if "ms" in row else ""), flush=True)
                    if not ok:
                        raise SystemExit(f"{name} disagrees with its plain "
                                         f"version: {row}")
    return rows, summary


def check_conv_edges(torch, gc):
    """Forward, dX and dW against their plain versions at the edge
    geometries, f32 and bf16, same tolerances; then two bf16 dW calls at
    layer 1, scale 0 must be bitwise equal."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, t, cin, cout, k, s, pad, g in EDGE_GEOMETRIES:
        t_out = gc.out_length(t, k, s, pad, pad)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = torch.randn(b, cin, t, device="cuda", generator=gen).to(dtype)
            w = torch.randn(cout, cin // g, k, device="cuda",
                            generator=gen).to(dtype)
            dy = torch.randn(b, cout, t_out, device="cuda",
                             generator=gen).to(dtype)
            pairs = {"grouped_conv_fwd": (
                         gc.conv_fwd(x, w, s, pad, pad, g),
                         gc.conv_fwd_plain(x, w, s, pad, pad, g)),
                     "grouped_conv_dx": (gc.conv_dx(dy, w, s, pad, t, g),
                                         gc.conv_dx_plain(dy, w, s, pad, t, g)),
                     "grouped_conv_dw": (
                         gc.conv_dw(x, dy, k, s, pad, pad, g),
                         gc.conv_dw_plain(x, dy, k, s, pad, pad, g))}
            for name, (got, want) in pairs.items():
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                rel = err / max(want.float().abs().max().item(), 1e-30)
                row = {"kernel": name, "geometry": [b, t, cin, cout, k, s, pad, g],
                       "dtype": dname, "max_abs_err": err, "max_rel_err": rel,
                       "tol": TOL[dname], "ok": rel <= TOL[dname]}
                rows.append(row)
                print(f"[edge] {name} {row['geometry']} {dname}: rel "
                      f"{rel:.3e} (tol {TOL[dname]:g})", flush=True)
                if not row["ok"]:
                    raise SystemExit(f"{name} disagrees with its plain "
                                     f"version: {row}")
    cin, cout, k, s, g, pad = GROUPED_LAYERS[0]
    x = torch.randn(PAIRED_BATCH, cin, CHUNK, device="cuda",
                    generator=gen).bfloat16()
    dy = torch.randn(PAIRED_BATCH, cout, gc.out_length(CHUNK, k, s, pad, pad),
                     device="cuda", generator=gen).bfloat16()
    same = torch.equal(gc.conv_dw(x, dy, k, s, pad, pad, g),
                       gc.conv_dw(x, dy, k, s, pad, pad, g))
    print(f"[edge] grouped_conv_dw bf16 layer1 scale0 twice: bitwise equal "
          f"{same}", flush=True)
    if not same:
        raise SystemExit("conv_dw is not deterministic")
    return {"rows": rows, "dw_bitwise_equal": same}


def check_adamw(torch, fa, models):
    """Kernel vs plain AdamW over generator- and discriminator-size
    parameter sets, 3 steps; timed per network update."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    summary = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes"}
    rows = []
    for net in ("generator", "discriminator"):
        shapes = [p.shape for p in getattr(models, net).parameters()]
        n = sum(int(torch.Size(s).numel()) for s in shapes)
        base = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
        grads = [[torch.randn(s, device="cuda", generator=gen)
                  for s in shapes] for _ in range(3)]
        pk = [p.clone() for p in base]
        pp = [p.clone() for p in base]
        sk = fa.adamw_init(pk, lr=2e-4, b1=0.8, b2=0.99)
        sp = fa.adamw_init(pp, lr=2e-4, b1=0.8, b2=0.99)
        for g in grads:
            fa.fused_adamw_(sk, g)
            sp.count.add_(1)
            fa.adamw_plain_(sp.params, g, sp.exp_avg, sp.exp_avg_sq,
                            sp.hyper, sp.count)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item()
                  for pair in ((pk, pp), (sk.exp_avg, sp.exp_avg),
                               (sk.exp_avg_sq, sp.exp_avg_sq))
                  for a, b in zip(*pair))
        tol = 1e-6
        lib_params = [torch.nn.Parameter(p.clone()) for p in base]
        for p, g in zip(lib_params, grads[0]):
            p.grad = g
        lib = torch.optim.AdamW(lib_params, lr=2e-4, betas=(0.8, 0.99),
                                eps=1e-8, weight_decay=1e-2, fused=True)
        b_ms, b_by = bound_ms(28.0 * n, 15.0 * n, "float32")
        row = {"kernel": "fused_adamw", "network": net, "params": n,
               "leaves": len(shapes), "max_abs_err": err, "tol": tol,
               "ms": cuda_time(lambda: fa.fused_adamw_(sk, grads[0])),
               "plain_ms": cuda_time(lambda: fa.adamw_plain_(
                   sp.params, grads[0], sp.exp_avg, sp.exp_avg_sq, sp.hyper,
                   sp.count)),
               "library_ms": cuda_time(lib.step), "bound_ms": b_ms,
               "bound_by": b_by}
        rows.append(row)
        print(f"[adamw] {net} ({n} params, {len(shapes)} leaves): max|err| "
              f"{err:.3e} (tol {tol:g}) kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.4f} ms library {row['library_ms']:.4f} ms "
              f"bound {b_ms:.4f} ms", flush=True)
        if not err <= tol:
            raise SystemExit(f"AdamW kernel disagrees with its plain version: "
                             f"{row}")
        summary["max_abs_err"] = max(summary["max_abs_err"], err)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            summary[key] += row[key]
    return rows, summary


def check_small_reference(Config, tgan):
    """Two f32 steps of a narrow configuration: CUDA kernels vs the CPU
    plain versions, same seed and batch. Tolerance rtol 1e-3 on losses."""
    cfg = Config()
    cfg.train.chunk_size, cfg.train.batch_size = 512, 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.model.params = {"channels": 32}
    cfg.emg_encoder.params = {"model_size": 32, "num_transformer_layers": 1,
                              "num_heads": 4, "dim_feedforward": 64,
                              "dropout": 0.0}
    results = {}
    for device in ("cuda", "cpu"):
        models = tgan.build_models(cfg, seed=0, device=device)
        state = tgan.init_state(cfg, models)
        step = tgan.make_train_step(cfg, models)
        for i in range(2):
            _, metrics = step(state, tgan.synthetic_batch(cfg, device,
                                                          seed=i))
        results[device] = {k: float(v) for k, v in metrics.items()}
    worst = 0.0
    for key, want in results["cpu"].items():
        got = results["cuda"][key]
        rel = abs(got - want) / max(abs(want), 1e-6)
        worst = max(worst, rel)
        if rel > 1e-3:
            raise SystemExit(f"small-input step disagrees with the CPU: {key} "
                             f"{got} vs {want}")
    print(f"[reference] narrow f32 step, cuda vs cpu: worst relative loss "
          f"difference {worst:.3e} (tol 1e-3)", flush=True)
    return {"worst_rel": worst, "cuda": results["cuda"], "cpu": results["cpu"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ste_gan_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from ste_gan_torch.config import Config
    from ste_gan_torch.device import card_line
    from ste_gan_torch.ops import build
    from ste_gan_torch.ops import fused_adamw as fa
    from ste_gan_torch.ops import grouped_conv as gc
    from ste_gan_torch.train import gan as tgan

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}", flush=True)
    build_s = build.build_all()
    print(f"[build] kernels built in {build_s:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in ptxas_summary(log):
            print(f"[build] {name}: {line}", flush=True)

    report = {"card": card, "build_s": build_s}
    conv_rows, conv_summary = check_grouped_conv(torch, gc, F)
    report["conv"] = conv_rows
    report["conv_edges"] = check_conv_edges(torch, gc)

    cfg, models, state, step, batch = tgan.main_path(seed=0)
    adamw_rows, adamw_summary = check_adamw(torch, fa, models)
    report["adamw"] = adamw_rows
    report["reference"] = check_small_reference(Config, tgan)

    # ---- The main path at full width. ----
    counters = {"grouped_conv_fwd": gc.conv_fwd, "grouped_conv_dx": gc.conv_dx,
                "grouped_conv_dw": gc.conv_dw, "fused_adamw": fa.fused_adamw_}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 3, 10
    t0 = time.perf_counter()
    for _ in range(warmup):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    sec_per_step = (time.perf_counter() - t0) / timed
    launches = {name: fn.launches for name, fn in counters.items()}
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if v != v or abs(v) == float("inf")]
    if bad:
        raise SystemExit(f"non-finite metrics: {bad}")
    expected = {"loss/generator", "loss/discriminator", "loss/adversarial",
                "loss/multi_td", "loss/speech_unit", "loss/phoneme",
                "loss/feature_matching"}
    if not expected <= set(values):
        raise SystemExit(f"missing metrics: {expected - set(values)}")
    ch_samples = cfg.train.batch_size * cfg.train.chunk_size * cfg.data.num_emg_channels
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[step] batch {cfg.train.batch_size} x {cfg.train.chunk_size} bf16: "
          f"{1e3 * sec_per_step:.2f} ms/step, {ch_samples / sec_per_step:.1f} "
          f"EMG channel-samples/s, peak {peak_gib:.2f} GiB, first {warmup} "
          f"steps {first_s:.2f} s ({card})", flush=True)
    print(f"[step] metrics {json.dumps(values)}", flush=True)
    report["step"] = {"sec_per_step": sec_per_step, "timed_steps": timed,
                      "warmup_steps": warmup,
                      "ch_samples_per_s": ch_samples / sec_per_step,
                      "peak_gib": peak_gib, "metrics": values,
                      "launches": launches}
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")

    source = {"grouped_conv_fwd": "ste_gan_torch/csrc/grouped_conv.cu",
              "grouped_conv_dx": "ste_gan_torch/csrc/grouped_conv.cu",
              "grouped_conv_dw": "ste_gan_torch/csrc/grouped_conv.cu",
              "fused_adamw": "ste_gan_torch/csrc/adamw.cu"}
    replaces = {"grouped_conv_fwd": "ste_gan_tpu/ops/pallas_conv.py:147",
                "grouped_conv_dx": "ste_gan_tpu/ops/pallas_conv.py:282",
                "grouped_conv_dw": "ste_gan_tpu/ops/pallas_conv.py:158",
                "fused_adamw": "ste_gan_tpu/ops/fused_adamw.py:49"}
    #: The CUDA kernels each wrapper launches on the main path (bf16).
    cuda_kernels = {"grouped_conv_fwd": "conv_fwd_bf16_kernel",
                    "grouped_conv_dx": "conv_dx_kernel",
                    "grouped_conv_dw": "conv_dw_partial_kernel + "
                                       "conv_dw_reduce_kernel",
                    "fused_adamw": "adamw_multi_tensor_kernel"}
    summaries = dict(conv_summary, fused_adamw=adamw_summary)
    kernels = [{"name": name, "route": "cuda", "source": source[name],
                "kernel": cuda_kernels[name], "replaces": replaces[name],
                "launches": launches[name], **summaries[name]}
               for name in counters]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
