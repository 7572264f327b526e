#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of ``ste_gan_torch/csrc`` (one ``nvcc`` per source, in parallel)
   and print each compiled kernel's registers and spills (``ptxas -v``);
   ``[probe]``: the cycles of one dependent f64 operation, one f32 DTW cell
   step and one dependent shared-memory load (``latency_probe_kernel``),
   which the recurrence kernels' chain bounds use;
2. each kernel, through the wrapper the main path calls (``conv_fwd``,
   ``conv_dx``, ``conv_dw``, ``fused_adamw_``), against its plain PyTorch
   version on the card, at the shapes of the main path: the grouped conv's
   forward and dX (bf16: ``conv_fwd_wgmma_kernel``,
   ``conv_dx_wgmma_kernel``, each after ``conv_weight_layout_kernel``) and
   dW (bf16: ``conv_dw_wgmma_kernel``, with each geometry's cluster size,
   CTA count and the clusters the card holds at once) at all six (layer,
   scale) geometries of the small scale discriminators on the paired
   2B = 64 batch, in f32 (TF32 off) and bf16; forward, dX and dW also at
   the edge geometries of ``tests/test_torch_grouped_conv.py`` (strides
   1/2/4, groups 1-16, down to 2 input and 4 output channels per group, 128
   output channels per group, odd lengths), one with K < stride and the
   full scale discriminators' five grouped layers (K 41, strides 1-4,
   groups 4-16, up to 1024 channels) at three scales, in both types; two
   bf16 calls of each of forward, dX and dW must agree bit for bit, and the
   layout kernel must equal ``_layout_weights``; AdamW over
   generator- and discriminator-size parameter sets for 3 steps. Kernel,
   plain and library times come from CUDA events; the bound is the larger of
   bytes over 3.35 TB/s and operations over the peak rate for the operand
   type;
3. a small-input reference: two f32 train steps of a narrow configuration
   through the CUDA kernels agree with the same steps on the CPU (the
   kernels' plain versions); so do two steps of the same configuration
   with ``grad_accum=2`` and the eval step on its EMA weights;
4. the main path at full width (``ste_gan_torch.train.gan.main_path``):
   ``Config()`` (batch 32 x 2048 samples, the 768-channel generator, the
   small discriminator ensemble, the full encoder, all five loss families,
   bf16 compute) with ``generator_ema=0.999``, seeded random weights and a
   numpy-seeded synthetic batch; 3 warm-up and 10 timed steps; every loss finite. Each
   kernel's launch count is set to 0 just before and read just after, and
   must be above 0;
5. the trainer CLI (``ste_gan_torch.train.train_gan``) at the shipped
   configuration (``configs/ste_gan_base_gantts.yaml``,
   ``configs/data/synthetic.yaml``) on the port's synthetic corpus (96/24/16
   utterances, made under ``build/``), with short intervals: step indices
   0-9 over 4 epochs of 3 steps, validation and periodic saves every 3
   steps, then a resume with ``--continue_run`` to 12. Launch counts are set
   to 0 before and must be above 0 after; every logged loss finite; the
   checkpoints, ``.done`` and ``best.meta.json`` present; the final learning
   rate ``2e-4 * 0.999^3``; the resume restores ``checkpoint-00000009`` at
   step 10. A third run resumes to 100 at the shipped interval_log 50 with
   no validation or checkpoint write, so the window of steps 51-100 times
   the trainer alone. Prints the trainer's ms/step at its steady steps and
   in that window beside the bare step's, and its validation and
   blocking-save times; then 10 more bare steps, so that the trainer is
   bracketed by bare steps of the same process;
6. encoder pre-training (``ste_gan_torch.train.encoder``):
   ``[dtw]`` the ``dtw_align_kernel`` against its plain version, alignments
   identical at the mixed corpus's slot shapes, a 500 x 600 utterance, a
   1,000 x 1,000 slot whose direction codes exceed shared memory, 2,100
   rows (strips), the edges and tied costs, with kernel, plain and bound
   ms (the chain of diagonals and walk steps at the probe's latencies);
   ``[encoder]`` two narrow f32 encoder steps, voiced and mixed, on the
   card and on the CPU (TF32 off, rtol 1e-3); ``[encoder-step]`` the bare
   train step at full width (``configs/emg_encoder/conv_transformer.yaml``)
   on a folded batch of 80 windows, 3 warm-up and 10 timed steps with
   cuDNN TF32 on (PyTorch's default, what the CLI gets) and off, every
   loss finite, and AdamW at the encoder's parameter set;
   ``[encoder-trainer]`` the CLI at full width on
   the port's synthetic corpus, voiced for 3 epochs and mixed
   (``--silent_fraction 0.25``, ``--include_silent``) for 2, launch counts
   zeroed before each run and above 0 after it (DTW in the mixed run), then
   ``best_val_loss_model.pt`` loaded strictly by the GAN trainer's
   ``load_frozen_encoder``, its weights equal to the file's and its outputs
   within 1e-5 of the saved encoder's;
7. ``[infer]``: the synthesizer (``ste_gan_torch.infer``), narrow f32 on
   the card against the CPU; at the full width of
   ``configs/ste_gan_base_gantts.yaml`` (seeded weights, f32, TF32 off)
   bucketed against exact and streaming interiors against the full
   utterance (500 frames); the real-time factor at batch 1 x 500 frames
   and at a bucketed 16 x 64 in f32 with TF32 off and on and in bf16;
   ``convert_dataset`` over the trainer's synthetic test split, cold and
   warm; the full-width ``EMGDecoder`` on 10 s and 30 s of EMG, streaming
   against the full decode;
8. ``[evaluate]``: ``python -m ste_gan_torch.evaluate gan --full
   --realism`` on the GAN run directory of phase 5 with the encoder of
   phase 6, ``evaluate encoder`` voiced and with ``--include_silent`` (its
   ``dtw_align_kernel`` launches counted), every reported number finite,
   then ``generate_emg`` on the same run directory;
9. ``[export]``: the export CLIs on the same runs, each with ``--verify``
   (``python -m ste_gan_torch.export_generator``: f32 serving, f32 minimal
   and int8 serving; ``export_emg_encoder``: f32 and int8), with export
   seconds, artifact MB and the int8 deviation; the full-width f32 serving
   artifact against ``EMGSynthesizer.synthesize_padded`` on a padded batch
   with per-row valid lengths (TF32 off, within ``INFER_TOL``); a narrow
   artifact traced on the CPU, loaded on the card through the device move
   and held to the same generator there; one call of the int8 and of the
   f32 artifact timed, and the int8 program's per-call dequantisation;
10. ``[serve]``: ``python -m ste_gan_torch.serve_load`` at full width on
   the GAN run and on the f32 serving artifact (8 clients x 50 requests of
   64 frames, ``max_batch`` 8, ``max_wait_ms`` 5, bucket 64): client and
   server p50/p95/p99, batch occupancy, 503s, requests/s and seconds of EMG
   per second; then one f32 server with the encoder checkpoint behind
   ``/decode`` (10 s of EMG, held to the encoder), sessions outside the
   table answered 400 with the card serving on, ``/synthesize_stream`` of
   a 500-frame utterance against the full synthesis (``INFER_TOL``), and a
   ``/reload``
   under the same load that no request may fail, after which the served
   weights must equal the checkpoint's. The trainer phases' directories
   are removed after this phase;
11. ``[etl]``: ``filtfilt_kernel`` (``ste_gan_torch/csrc/iir.cu``) against
   its plain version on the card at the prep's shapes (8 rows x 15,000
   samples through the eight-stage notch-plus-drift cascade, 8 x 4,000
   through the Hilbert envelope's 20 Hz low-pass, 512 rows of 1,000-4,000
   samples, all resident in shared memory) and 8 x 40,000 through the
   cascade (streamed), bit for bit (max |difference| 0), kernel, plain and
   bound ms (the chain of dependent f64 operations at the probe's latency,
   bytes and operations);
   the MFCC frontend and ``get_emg_features`` on the card against the CPU;
12. ``[prep]``: ``python -m ste_gan_torch.clean_audio`` then
   ``python -m ste_gan_torch.prep_data`` on the card over a synthetic raw
   Gaddy & Klein tree (three sessions, 48 utterances of 3-8 s, 8-channel
   1 kHz EMG, 16 kHz audio, TextGrids) with a HuBERT stand-in on the card:
   seconds of EMG per second, ms per utterance, ``filtfilt_kernel``
   launches (zeroed just before the prep, above 0 after), the invariants,
   the split routing and a load with the port's dataset; then two voiced
   utterances prepared on the card and on the CPU agree;
13. ``[moe]``: the mixture-of-experts encoder
   (``configs/emg_encoder/conv_transformer_moe.yaml``): narrow voiced and
   mixed steps on the card against the CPU (rtol 1e-3); the full-width step
   on the 128,000-sample budget, voiced and mixed, with its peak memory held
   far under what ``[S, E, C]`` one-hot tensors would add; the encoder CLI
   with the MoE config, voiced and mixed, one epoch each; its checkpoint
   loaded strictly into ``EMGDecoder`` and into the GAN trainer (3 steps);
14. ``[dist]``: the data-parallel family on the one card
   (``check_dist``): the DP and FSDP wrappers at one NCCL rank against the
   bare step and its reruns, full width; the hand kernels at this phase's
   shapes; two ranks sharing the card over gloo through the worker CLI
   (``python -m ste_gan_torch.parallel.multiprocess --full``), DP and
   FSDP, against one rank by losses, weights and the ranks' equality, and
   a control without the gradient all-reduce that must fail; NCCL at two
   ranks with two cards only; the launcher's elastic recovery of a killed
   rank against its recovery point continued on one rank (the fleet runs
   beside the trainer CLIs); ``train_gan`` and ``train.encoder`` at two
   ranks and the two-rank checkpoint resumed by the single-device trainer;
   and a two-replica ``EMGSynthesizer`` on the card named twice. Two ranks
   on one card check correctness and the collectives' cost, not scaling;
15. ``[tp]``: tensor parallelism on the one card (``check_tp_kernels``,
   ``check_tp``): the grouped-conv kernels (forward, dX, dW; f32 and bf16)
   at every per-rank geometry of the small and full discriminators at 2 and
   4 model ranks and of the tiny one at 2, and AdamW over each rank's slabs
   (GAN, tiny GAN and its hybrid-FSDP shard, encoder), against their plain
   versions, all read from modules split by ``shard_module_``; the worker at ``(data, model) = (1, 2)`` at full width on two
   gloo ranks (losses, weights and the ranks' equality against [dist]'s
   world 1; ms/step, collectives and state bytes per rank); a control
   without ``copy_to_model``'s backward sum that a gate must catch; the
   tiny (1, 2) ``--fsdp`` and (2, 2) layouts against the tiny world 1;
   ``train_gan`` handing its checkpoint from world 1 to (1, 2) and back,
   against the same steps uninterrupted at world 1; one voiced epoch of
   ``train.encoder --model_parallel 2`` against world 1's first epoch;
16. ``[sp]``: ``python -m ste_gan_torch.parallel.sequence_parallel`` at
   full width on 2 gloo ranks (500 and 1,500 frames) and 4 (200 frames,
   three hops), each against one-device synthesis (TF32 off), ms per call;
17. ``[pp]``, ``[ep]``, ``[axes]``: pipeline and expert parallelism on the
   one card, gloo ranks sharing it (``check_pp_ep_kernels``, ``check_pp``,
   ``check_ep_axes``): AdamW against its plain version at each per-rank
   set (a stage of the full encoder at 2 and 3 stages, an expert rank of
   the MoE encoder at expert axis 2, the axes worker's sets); the
   full-width encoder at 2 stages of 80 one-window microbatches (one
   fold's forward and gradients against world 1, four trainer steps
   against world 1's losses and weights, ms/step, messages and state
   bytes per rank, and a control without the stage-group gradient sum
   that the weight gate must catch) beside one voiced epoch of
   ``train.encoder --pipeline_stages 2`` against [encoder-trainer]'s first
   epoch; the full-width MoE encoder at ``(data, expert) = (1, 2)`` and
   ``(2, 1)``, two steps each at the configuration's capacity and at a
   dropping one (losses and dropped picks against world 1, collectives,
   state bytes) and a control with local slot offsets; both modes of
   ``python -m ste_gan_torch.parallel.multiprocess_axes`` on two processes
   against its one-process oracle, the processes' dumps equal;
18. the ``kernels`` JSON line (each kernel's launches on the main path,
   under ``dist_launches`` on the [dist] paths, ``tp_launches`` on the
   [tp] paths and ``pp_ep_axes_launches`` on the [pp], [ep] and [axes]
   paths, per rank, with the shapes held in each), the card line, and the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no CUDA device is present or when
run outside a checkout of the repository. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
#: Dense peaks of one H100 SXM (NVIDIA's data sheet); float64 is the CUDA
#: cores' rate, which the filter kernel uses.
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # max |kernel - plain| / max |plain|
#: Max |difference| of the full-width f32 synthesis (TF32 off) between
#: bucketed and exact, and between streaming interiors and the full
#: utterance: f32 reduction noise through 41 convs, where cuDNN may pick
#: another algorithm for another length.
INFER_TOL = 1e-4
#: Max |streamed - full| / max |full| of the full-width decoder (TF32 off).
DECODE_TOL = 1e-4
#: Small scale discriminator grouped layers: (Cin, Cout, K, stride, groups, pad).
GROUPED_LAYERS = ((128, 256, 37, 2, 4, 18), (256, 512, 37, 2, 16, 18))
PAIRED_BATCH = 64
CHUNK = 2048
#: The trainer phase: step indices 0-9, a resume to 12, then a steady
#: window to 100.
TRAINER_STEPS, RESUME_STEPS, STEADY_STEPS = 9, 12, 100
#: Edge geometries (B, T, Cin, Cout, K, stride, pad, groups): the CASES of
#: tests/test_torch_grouped_conv.py, then K < stride (a phase without taps).
EDGE_GEOMETRIES = ((2, 64, 16, 32, 15, 1, 7, 1), (2, 64, 32, 64, 9, 2, 4, 4),
                   (2, 64, 32, 64, 9, 2, 4, 16), (2, 64, 32, 64, 9, 4, 4, 8),
                   (1, 50, 16, 16, 5, 2, 2, 4), (2, 64, 32, 256, 5, 1, 2, 2),
                   (2, 33, 8, 16, 3, 4, 1, 2))
#: The full scale discriminators' grouped layers (``FULL_SCALE_SPEC`` of
#: ste_gan_torch/models/discriminator.py, K 41) at 2B = 64, scale 0 (B, T,
#: Cin, Cout, K, stride, pad, groups); scales 1 and 2 halve T.
FULL_SCALE_GEOMETRIES = ((64, 2048, 128, 128, 41, 2, 20, 4),
                         (64, 1024, 128, 256, 41, 2, 20, 16),
                         (64, 512, 256, 512, 41, 4, 20, 16),
                         (64, 128, 512, 1024, 41, 4, 20, 16),
                         (64, 32, 1024, 1024, 41, 1, 20, 16))


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


def bound_ms(nbytes: float, ops: float, dtype_name: str,
             chain_ms: float = 0.0):
    """The least time of a call: bytes over the memory rate, operations
    over the type's peak rate and, for a recurrence, its chain of dependent
    steps at the probe's latencies; the larger, and which it is."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype_name]
    best = max(t_bytes, t_ops, chain_ms)
    return best, ("chain" if best == chain_ms and chain_ms > t_bytes
                  else "bytes" if t_bytes >= t_ops else "operations")


def check_probe(torch, build, card):
    """The card's latencies behind the recurrence kernels' chain bounds
    (``latency_probe_kernel``, ``ste_gan_torch/csrc/probe.cu``): cycles per
    dependent f64 operation (``__dadd_rn``, ``__dmul_rn``, ``__dsub_rn``),
    per f32 DTW cell step (``fminf``, ``fminf``, ``__fadd_rn``) and per
    dependent shared-memory load, one thread timing each chain with
    ``clock64()``, and the maximum SM clock they are counted at."""
    seeds = torch.tensor((0.25, 1.5, 0.5, 3.0, 7.0, 9.0, 8.0, 0.5, 5.0),
                         dtype=torch.float64, device="cuda")
    out = torch.zeros(4, dtype=torch.float64, device="cuda")
    build.check(build.load("probe").latency_probe(
        seeds.data_ptr(), out.data_ptr(), 4096,
        torch.cuda.current_stream().cuda_stream), "latency_probe")
    f64_op, f32_cell, smem, checksum = out.tolist()
    if not checksum == checksum:
        raise SystemExit("latency_probe: its chains did not stay finite")
    cycles = {"f64_op": f64_op, "f32_cell_step": f32_cell, "smem_load": smem}
    clock = sm_clock_hz()
    print(f"[probe] cycles per dependent f64 operation (__dadd_rn, __dmul_rn,"
          f" __dsub_rn) {f64_op:.3f}; per f32 DTW cell step (fminf, fminf, "
          f"__fadd_rn) {f32_cell:.3f}; per dependent shared-memory load "
          f"{smem:.3f}; at {clock / 1e9:.3f} GHz ({card})", flush=True)
    return {"cycles": cycles, "clock_hz": clock}


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
                        if name == "grouped_conv_dw":
                            # conv_dw_wgmma_kernel's launch: clusters of
                            # C CTAs, and how many the card holds at once.
                            plan = gc._plan_dw_for(x, dy, k, s, pad, g)
                            row.update(cluster=plan.C, ctas=plan.grid,
                                       clusters=plan.n_tiles,
                                       clusters_held=gc._cluster_table(
                                           torch.cuda.current_device())[
                                               plan.C - 1],
                                       units_per_warpgroup=plan.UW,
                                       wgmma_n=plan.nt_w)
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
                             f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
                             f"{100 * row['bound_ms'] / row['ms']:.1f} % of "
                             f"the bound, kernel/library "
                             f"{row['ms'] / row['library_ms']:.3f}"
                             if "ms" in row else "")
                          + (f"; {row['clusters']} clusters of "
                             f"{row['cluster']} CTAs = {row['ctas']} CTAs "
                             f"({row['clusters_held']} such clusters held "
                             f"at once), {row['units_per_warpgroup']} units "
                             f"of N {row['wgmma_n']} a warpgroup"
                             if "cluster" in row else ""), flush=True)
                    if not ok:
                        raise SystemExit(f"{name} disagrees with its plain "
                                         f"version: {row}")
    for name, agg in summary.items():
        agg["bound_share"] = agg["bound_ms"] / agg["ms"]
        agg["kernel_over_library"] = agg["ms"] / agg["library_ms"]
        print(f"[conv] {name} bf16, sum of the six geometries: kernel "
              f"{agg['ms']:.4f} ms, bound {agg['bound_ms']:.4f} ms "
              f"({agg['bound_by']}), {100 * agg['bound_share']:.1f} % of the "
              f"bound, library {agg['library_ms']:.4f} ms, kernel/library "
              f"{agg['kernel_over_library']:.3f}", flush=True)
    return rows, summary


def hold_conv(torch, gc, geometries, gen, label):
    """Forward, dX and dW against their plain versions at each geometry
    (B, T, Cin, Cout, K, stride, pad, groups), f32 and bf16, at ``TOL``;
    fatal on a disagreement. Returns one row per kernel, geometry and
    dtype."""
    rows = []
    for b, t, cin, cout, k, s, pad, g in geometries:
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
                       "tol": TOL[dname], "ok": rel <= TOL[dname],
                       "set": label}
                rows.append(row)
                print(f"[{label}] {name} {row['geometry']} {dname}: rel "
                      f"{rel:.3e} (tol {TOL[dname]:g})", flush=True)
                if not row["ok"]:
                    raise SystemExit(f"{name} disagrees with its plain "
                                     f"version: {row}")
    return rows


def check_conv_edges(torch, gc):
    """Forward, dX and dW against their plain versions at the edge
    geometries and at the full scale discriminators' grouped layers (three
    scales), f32 and bf16, same tolerances; then two bf16 calls of each at
    layer 1, scale 0 must be bitwise equal, and the weight layout kernel
    (``grouped_conv1d_weight_layout``) must equal ``_layout_weights`` for
    the forward and dX at both main-path layers."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    full = [(b, t >> scale, *rest) for b, t, *rest in FULL_SCALE_GEOMETRIES
            for scale in range(3)]
    rows = (hold_conv(torch, gc, EDGE_GEOMETRIES, gen, "edge")
            + hold_conv(torch, gc, full, gen, "full-disc"))
    cin, cout, k, s, g, pad = GROUPED_LAYERS[0]
    x = torch.randn(PAIRED_BATCH, cin, CHUNK, device="cuda",
                    generator=gen).bfloat16()
    dy = torch.randn(PAIRED_BATCH, cout, gc.out_length(CHUNK, k, s, pad, pad),
                     device="cuda", generator=gen).bfloat16()
    w = (torch.randn(cout, cin // g, k, device="cuda", generator=gen)
         / (k * cin / g) ** 0.5).bfloat16()
    twice = {"grouped_conv_fwd": lambda: gc.conv_fwd(x, w, s, pad, pad, g),
             "grouped_conv_dx": lambda: gc.conv_dx(dy, w, s, pad, CHUNK, g),
             "grouped_conv_dw": lambda: gc.conv_dw(x, dy, k, s, pad, pad, g)}
    bitwise = {}
    for name, fn in twice.items():
        bitwise[name] = torch.equal(fn(), fn())
        print(f"[edge] {name} bf16 layer1 scale0 twice: bitwise equal "
              f"{bitwise[name]}", flush=True)
    if not all(bitwise.values()):
        raise SystemExit(f"a grouped conv kernel is not deterministic: "
                         f"{bitwise}")
    from ste_gan_torch.ops import build
    layouts = {}
    for layer, (cin, cout, k, s, g, pad) in enumerate(GROUPED_LAYERS, 1):
        t_in = CHUNK // layer
        t_out = gc.out_length(t_in, k, s, pad, pad)
        w = torch.randn(cout, cin // g, k, device="cuda",
                        generator=gen).bfloat16()
        for kind in ("fwd", "dx"):
            plan = gc._plan_conv(kind == "dx", PAIRED_BATCH, cin, cout, k, s,
                                 pad, t_in, t_out, g)
            wp = torch.empty(plan.w_numel, device="cuda",
                             dtype=torch.bfloat16)
            build.check(build.load("grouped_conv").grouped_conv1d_weight_layout(
                w.data_ptr(), wp.data_ptr(), plan.args, plan.nt_w,
                torch.cuda.current_stream().cuda_stream),
                "grouped_conv1d_weight_layout")
            same = torch.equal(wp, gc._layout_weights(w, plan).reshape(-1))
            layouts[f"{kind}_layer{layer}"] = same
            print(f"[edge] conv_weight_layout_kernel {kind} layer{layer}: "
                  f"equal to _layout_weights {same}", flush=True)
    if not all(layouts.values()):
        raise SystemExit(f"the weight layout kernel disagrees: {layouts}")
    return {"rows": rows, "bitwise_equal": bitwise, "layouts_equal": layouts}


def adamw_row(torch, fa, shapes, gen, lr, b1, b2, weight_decay):
    """Kernel vs plain AdamW over leaves of ``shapes``: 3 updates of
    identical copies of the same seeded parameters with the same gradients;
    max |err| over the parameters and both moments (tol 1e-6, fatal), then
    kernel, plain and library ms of one update."""
    n = sum(int(torch.Size(s).numel()) for s in shapes)
    base = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
    grads = [[torch.randn(s, device="cuda", generator=gen)
              for s in shapes] for _ in range(3)]
    pk = [p.clone() for p in base]
    pp = [p.clone() for p in base]
    hyper = dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay)
    sk = fa.adamw_init(pk, **hyper)
    sp = fa.adamw_init(pp, **hyper)
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
    lib = torch.optim.AdamW(lib_params, lr=lr, betas=(b1, b2), eps=1e-8,
                            weight_decay=weight_decay, fused=True)
    b_ms, b_by = bound_ms(28.0 * n, 15.0 * n, "float32")
    row = {"kernel": "fused_adamw", "params": n, "leaves": len(shapes),
           "max_abs_err": err, "tol": tol,
           "ms": cuda_time(lambda: fa.fused_adamw_(sk, grads[0])),
           "plain_ms": cuda_time(lambda: fa.adamw_plain_(
               sp.params, grads[0], sp.exp_avg, sp.exp_avg_sq, sp.hyper,
               sp.count)),
           "library_ms": cuda_time(lib.step), "bound_ms": b_ms,
           "bound_by": b_by}
    if not err <= tol:
        raise SystemExit(f"AdamW kernel disagrees with its plain version: "
                         f"{row}")
    return row


def check_adamw(torch, fa, models):
    """Kernel vs plain AdamW over generator- and discriminator-size
    parameter sets, 3 steps; timed per network update."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    summary = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes"}
    rows = []
    for net in ("generator", "discriminator"):
        shapes = [p.shape for p in getattr(models, net).parameters()]
        row = {"network": net, **adamw_row(torch, fa, shapes, gen, lr=2e-4,
                                           b1=0.8, b2=0.99,
                                           weight_decay=1e-2)}
        rows.append(row)
        print(f"[adamw] {net} ({row['params']} params, {row['leaves']} "
              f"leaves): max|err| {row['max_abs_err']:.3e} (tol "
              f"{row['tol']:g}) kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.4f} ms library {row['library_ms']:.4f} ms "
              f"bound {row['bound_ms']:.4f} ms", flush=True)
        summary["max_abs_err"] = max(summary["max_abs_err"], row["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            summary[key] += row[key]
    return rows, summary


def narrow_config(Config, grad_accum: int = 1):
    """The narrow f32 configuration of the small-input reference phases."""
    cfg = Config()
    cfg.train.chunk_size, cfg.train.batch_size = 512, 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.train.grad_accum = grad_accum
    cfg.model.params = {"channels": 32}
    cfg.emg_encoder.params = {"model_size": 32, "num_transformer_layers": 1,
                              "num_heads": 4, "dim_feedforward": 64,
                              "dropout": 0.0}
    return cfg


def worst_relative(results, what: str) -> float:
    """Largest |cuda - cpu| / |cpu| over the metrics; fatal above 1e-3."""
    worst = 0.0
    for key, want in results["cpu"].items():
        got = results["cuda"][key]
        rel = abs(got - want) / max(abs(want), 1e-6)
        worst = max(worst, rel)
        if rel > 1e-3:
            raise SystemExit(f"{what} disagrees with the CPU: {key} "
                             f"{got} vs {want}")
    return worst


def check_small_reference(Config, tgan):
    """Two f32 steps of a narrow configuration: CUDA kernels vs the CPU
    plain versions, same seed and batch. Tolerance rtol 1e-3 on losses."""
    cfg = narrow_config(Config)
    results = {}
    for device in ("cuda", "cpu"):
        models = tgan.build_models(cfg, seed=0, device=device)
        state = tgan.init_state(cfg, models)
        step = tgan.make_train_step(cfg, models)
        for i in range(2):
            _, metrics = step(state, tgan.synthetic_batch(cfg, device,
                                                          seed=i))
        results[device] = {k: float(v) for k, v in metrics.items()}
    worst = worst_relative(results, "small-input step")
    print(f"[reference] narrow f32 step, cuda vs cpu: worst relative loss "
          f"difference {worst:.3e} (tol 1e-3)", flush=True)
    return {"worst_rel": worst, "cuda": results["cuda"], "cpu": results["cpu"]}


def check_small_accum_and_eval(Config, tgan):
    """The same narrow configuration with ``grad_accum=2``: two
    accumulating steps, then the eval step on the EMA weights; CUDA kernels
    vs the CPU plain versions. Tolerance rtol 1e-3."""
    cfg = narrow_config(Config, grad_accum=2)
    results = {}
    for device in ("cuda", "cpu"):
        models = tgan.build_models(cfg, seed=0, device=device)
        state = tgan.init_state(cfg, models)
        step = tgan.make_train_step(cfg, models)
        for i in range(2):
            _, metrics = step(state, tgan.synthetic_batch(cfg, device,
                                                          seed=i))
        with tgan.eval_generator_params(models, state):
            val = tgan.make_eval_step(cfg, models)(
                tgan.synthetic_batch(cfg, device, seed=7))
        results[device] = {
            **{f"accum {k}": float(v) for k, v in metrics.items()},
            **{f"eval {k}": float(v) for k, v in val.items()}}
    worst = {what: worst_relative(
        {d: {k: v for k, v in r.items() if k.startswith(what)}
         for d, r in results.items()}, f"narrow f32 {what} step")
        for what in ("accum", "eval")}
    print(f"[reference] narrow f32 step with grad_accum=2, cuda vs cpu: "
          f"worst relative difference {worst['accum']:.3e}; eval step on the "
          f"EMA weights: {worst['eval']:.3e} (tol 1e-3)", flush=True)
    return {"worst_rel": worst, "cuda": results["cuda"], "cpu": results["cpu"]}


def check_trainer(torch, counters, bare_ms: float, card: str):
    """The trainer CLI at the shipped configuration: the port's synthetic
    corpus at its CLI defaults, then ``configs/ste_gan_base_gantts.yaml``
    and ``configs/data/synthetic.yaml`` with short intervals, 10 steps
    (indices 0-9, 4 epochs of 3) and a resume to 12. Launch counts are
    zeroed before the first run and read after it. The run directory
    (``build/chip_smoke_trainer``) stays for the inference phases."""
    import logging

    import yaml

    from ste_gan_torch.config import create_ste_gan_model_name, load_config
    from ste_gan_torch.data import synthetic
    from ste_gan_torch.train import train_gan
    from ste_gan_torch.train.gan import epoch_lr

    work = ROOT / "build" / "chip_smoke_trainer"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.main(["--root", str(work / "synthetic")])
    corpus_s = time.perf_counter() - t0
    with open(ROOT / "configs" / "data" / "synthetic.yaml") as fp:
        data = yaml.safe_load(fp)
    data["dataset_root"] = str(work / "synthetic")
    (work / "data.yaml").write_text(yaml.safe_dump(data))
    configs = {}
    for name, train in (
            ("short", dict(interval_log=1, interval_valid=3, interval_save=3,
                           save_last_epoch_interval=1,
                           interval_sample=10_000)),
            # The shipped logging cadence, nothing else in the window.
            ("steady", dict(interval_valid=10_000, interval_save=10_000,
                            save_last_epoch_interval=10_000,
                            interval_sample=10_000))):
        with open(ROOT / "configs" / "ste_gan_base_gantts.yaml") as fp:
            base = yaml.safe_load(fp)
        base["model_base_dir"] = str(work / "exp")
        base["train"].update(train)
        configs[name] = work / f"config_{name}.yaml"
        configs[name].write_text(yaml.safe_dump(base))

    def argv(name, max_steps, *more):
        return ["--config", str(configs[name]), "--data",
                str(work / "data.yaml"), "--emg_enc_cfg",
                str(ROOT / "configs" / "emg_encoder" / "conv_transformer.yaml"),
                "--max_steps", str(max_steps), *more]

    cfg = load_config(str(configs["short"]), str(work / "data.yaml"))
    run = work / "exp" / create_ste_gan_model_name(cfg, add_timestamp=False)

    messages = []

    class Capture(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    capture = Capture()
    logging.getLogger().addHandler(capture)
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        train_gan.main(train_gan.parse_args(argv("short", TRAINER_STEPS)))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        missing = [name for name, n in launches.items() if n <= 0]
        if missing:
            raise SystemExit(f"kernels never launched by the trainer: "
                             f"{missing}")
        for entry in (".done", "config.yaml", "checkpoint-00000003",
                      "checkpoint-00000006", "checkpoint-00000009",
                      "checkpoint-final", "checkpoint-last", "best"):
            if not (run / entry).exists():
                raise SystemExit(f"trainer run dir lacks {entry}")
        best = json.loads((run / "best.meta.json").read_text())
        if "su_error" not in best:
            raise SystemExit(f"best.meta.json has no su_error: {best}")
        final = torch.load(run / "checkpoint-final" / "state.pt",
                           map_location="cpu", weights_only=True, mmap=True)
        want_lr = float(torch.tensor(epoch_lr(cfg, 3), dtype=torch.float32))
        got_lr = [float(final[o]["hyper"][0]) for o in ("opt_g", "opt_d")]
        if final["step"] != TRAINER_STEPS + 1 or got_lr != [want_lr] * 2:
            raise SystemExit(f"final checkpoint: step {final['step']}, "
                             f"learning rates {got_lr} (want {want_lr})")
        ckpt_mb = (run / "checkpoint-final" / "state.pt").stat().st_size / 2**20
        del final

        (run / ".done").unlink()
        messages.clear()
        t0 = time.perf_counter()
        train_gan.main(train_gan.parse_args(
            argv("short", RESUME_STEPS, "--continue_run")))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        restored = [m for m in messages if m.startswith(
            ("Resuming from checkpoint", "Restored train state"))]

        # A steady window: resumed at step 13, logged at the shipped
        # interval_log 50 with no validation and no checkpoint write before
        # the final save, so the window of steps 51-100 is the trainer's own.
        (run / ".done").unlink()
        train_gan.main(train_gan.parse_args(
            argv("steady", STEADY_STEPS, "--continue_run")))
        torch.cuda.synchronize()
    finally:
        logging.getLogger().removeHandler(capture)
    if (len(restored) != 2 or not restored[0].endswith("checkpoint-00000009")
            or "at step 10 " not in restored[1]):
        raise SystemExit(f"the resume did not restore checkpoint-00000009 at "
                         f"step 10: {restored}")

    logged = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        logged.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    losses = {tag: v for tag, v in logged.items()
              if tag.startswith("train_loss/")}
    steps = sorted(logged["train_loss/generator"])
    if steps != list(range(RESUME_STEPS + 1)) + [50, STEADY_STEPS]:
        raise SystemExit(f"logged steps {steps}")
    bad = [(tag, s) for tag, v in losses.items() for s, x in v.items()
           if x != x or abs(x) == float("inf")]
    if bad:
        raise SystemExit(f"non-finite logged losses: {bad}")
    # Steady steps: no validation, save or epoch boundary in the window
    # between the previous step's log and this one's, and not the first.
    ms = logged["perf/ms_per_step"]
    window_ms = ms[STEADY_STEPS]
    steady = [s for s in sorted(ms)
              if s % 3 and (s - 1) % 3 and 1 < s <= RESUME_STEPS]
    steady_ms = [ms[s] for s in steady]
    median_ms = sorted(steady_ms)[len(steady_ms) // 2]
    ch_samples = (cfg.train.batch_size * cfg.train.chunk_size
                  * cfg.data.num_emg_channels)
    val_s = logged["perf/validation_s"]
    report = {"corpus_s": corpus_s, "run_s": run_s, "resume_s": resume_s,
              "launches": launches, "ms_per_step": ms, "steady_steps": steady,
              "steady_ms_per_step": steady_ms,
              "median_ms_per_step": median_ms,
              "steady_window_ms_per_step": window_ms,
              "steady_window_ch_samples_per_s": ch_samples / window_ms * 1e3,
              "ch_samples_per_s": ch_samples / median_ms * 1e3,
              "validation_s": val_s,
              "final_save_s": logged["perf/final_save_s"],
              "checkpoint_mb": ckpt_mb, "best_su_error": best["su_error"],
              "learning_rate": want_lr}
    print(f"[trainer] corpus {corpus_s:.1f} s; steps 0-{TRAINER_STEPS} in "
          f"{run_s:.1f} s, resumed from checkpoint-00000009 (step 10) to "
          f"{RESUME_STEPS} in {resume_s:.1f} s; launches {launches}; "
          f"learning rate {want_lr:.9g}; best val SU {best['su_error']:.4f}",
          flush=True)
    print(f"[trainer] ms/step at steady steps {steady}: "
          f"{', '.join(f'{x:.2f}' for x in steady_ms)} (median "
          f"{median_ms:.2f} ms = {ch_samples / median_ms * 1e3:.1f} EMG "
          f"channel-samples/s); bare [step] {bare_ms:.2f} ms/step ({card})",
          flush=True)
    print(f"[trainer] steady window, steps 51-{STEADY_STEPS} at the shipped "
          f"interval_log 50 with no validation or checkpoint write: "
          f"{window_ms:.2f} ms/step = {ch_samples / window_ms * 1e3:.1f} EMG "
          f"channel-samples/s; bare [step] {bare_ms:.2f} ms/step ({card})",
          flush=True)
    print(f"[trainer] validation pass (24 utterances) s by step: "
          f"{json.dumps(val_s)}; blocking final save of {ckpt_mb:.0f} MB, s "
          f"by step: {json.dumps(logged['perf/final_save_s'])} ({card})",
          flush=True)
    # The run directory and its corpus stay for [infer] and [evaluate].
    report.update(run_dir=str(run), corpus=str(work / "synthetic"))
    return report


def dtw_bound(dtw, costs, ends, latency):
    """The least time of one ``dtw_alignment_batched`` call on these inputs:
    bytes (each valid cell's cost read once, the ends read, the alignments
    written), operations (3 f32 a valid cell) and the chain, the longest
    slot's ``lt + lp - 1`` anti-diagonals at one dependent f32 cell step
    each plus its walk's steps (counted on these costs by the plain
    direction-code walk) at one dependent shared-memory load each, at the
    probe's cycles and the card's maximum clock. Returns (bound ms, its
    kind, the chain's diagonals and steps of the slot that sets it)."""
    s, t1, t2 = costs.shape
    dtw_ends = ends.tolist()
    cells = sum((i + 1) * (j + 1) for i, j in dtw_ends if i >= 0 and j >= 0)
    nbytes = 4.0 * cells + 8.0 * s + 4.0 * s * t1
    _, steps = dtw.dtw_backtrace_codes_plain(dtw.dtw_directions_plain(costs),
                                             ends)
    cyc = latency["cycles"]
    chains = [((i + j + 1) * cyc["f32_cell_step"] + int(n) * cyc["smem_load"],
               i + j + 1, int(n))
              for (i, j), n in zip(dtw_ends, steps.tolist())
              if i >= 0 and j >= 0] or [(0.0, 0, 0)]
    chain_cycles, diagonals, walk = max(chains)
    b_ms, b_by = bound_ms(nbytes, 3.0 * cells, "float32",
                          1e3 * chain_cycles / latency["clock_hz"])
    return b_ms, b_by, diagonals, walk


def check_dtw(torch, dtw, latency):
    """``dtw_align_kernel`` against its plain version on the card: the
    alignments must be identical at the mixed corpus's slot shapes (24 slots
    of up to 259 x 259, one empty), a long real-utterance case (500 x 600),
    a slot whose direction codes exceed shared memory (1,000 x 1,000: the
    global-codes variant), rows past one block (2,100 x 300: strips) and
    the edges (an empty slot, 1 x N, N x 1, T1 > T2, ends short of the
    padded shape, integer costs that tie). Kernel ms from CUDA events at
    the first three (plain ms at the first two), bound ms at every case."""
    import numpy as np

    rng = np.random.default_rng(5)

    def ends_between(s, lo, t1, t2):
        return np.stack([rng.integers(lo, t1, s), rng.integers(lo, t2, s)],
                        1).astype(np.int32)

    mixed_ends = ends_between(24, 129, 259, 259)
    mixed_ends[0] = (258, 258)
    mixed_ends[1] = (-1, -1)
    cases = [("mixed corpus slots", (24, 259, 259), mixed_ends),
             ("long utterance", (1, 500, 600), np.array([[499, 599]], np.int32)),
             ("codes past shared memory", (1, 1000, 1000),
              np.array([[999, 999]], np.int32)),
             ("rows past one block", (2, 2100, 300),
              np.array([[2099, 299], [1500, 200]], np.int32)),
             ("empty slot", (2, 40, 40), np.array([[-1, -1], [39, 39]], np.int32)),
             ("1 x N", (2, 1, 300), np.array([[0, 299], [0, 10]], np.int32)),
             ("N x 1", (2, 300, 1), np.array([[299, 0], [10, 0]], np.int32)),
             ("T1 > T2", (3, 400, 150), np.array([[399, 149], [250, 60],
                                                   [399, 3]], np.int32)),
             ("ends short of the shape", (4, 200, 200),
              ends_between(4, 1, 150, 120)),
             ("integer costs (ties)", (4, 120, 90),
              ends_between(4, 60, 120, 90))]
    timed = ("mixed corpus slots", "long utterance", "codes past shared memory")
    plain_timed = timed[:2]
    rows, summary = [], None
    for name, shape, ends in cases:
        values = (rng.integers(0, 3, shape) if "ties" in name
                  else rng.random(shape))
        costs = torch.from_numpy(values.astype(np.float32)).cuda()
        ends_t = torch.from_numpy(ends).cuda()
        got = dtw.dtw_alignment_batched(costs, ends_t)
        want = dtw.dtw_alignment_plain(costs, ends_t)
        torch.cuda.synchronize()
        mismatched = int((got != want).any(dim=1).sum())
        b_ms, b_by, diagonals, walk = dtw_bound(dtw, costs, ends_t, latency)
        plan = dtw.plan_dtw(shape[1], shape[2])
        row = {"case": name, "shape": list(shape), "mismatched_rows":
               mismatched, "max_abs_err": float((got - want).abs().max()),
               "bound_ms": b_ms, "bound_by": b_by, "chain_diagonals":
               diagonals, "chain_walk_steps": walk,
               "variant": ("shared codes" if plan.shared_codes
                           else "global codes")
               + (", strips" if shape[1] > plan.threads else ""),
               "smem_bytes": plan.smem_bytes}
        if name in timed:
            row["ms"] = cuda_time(lambda: dtw.dtw_alignment_batched(
                costs, ends_t))
        if name in plain_timed:
            row["plain_ms"] = cuda_time(
                lambda: dtw.dtw_alignment_plain(costs, ends_t), reps=2,
                warmup=1)
        rows.append(row)
        print(f"[dtw] {name} {list(shape)} ({row['variant']}, "
              f"{plan.smem_bytes} B of shared memory): identical "
              f"{mismatched == 0}; bound {b_ms:.5f} ms ({b_by}: {diagonals} "
              f"diagonals + {walk} walk steps)"
              + (f"; kernel {row['ms']:.4f} ms" if "ms" in row else "")
              + (f", plain {row['plain_ms']:.2f} ms" if "plain_ms" in row
                 else ""), flush=True)
        if mismatched:
            raise SystemExit(f"dtw_align_kernel disagrees with its plain "
                             f"version: {row}")
        if summary is None:
            summary = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by")}
            summary["library_ms"] = None
    summary["mismatched_rows"] = sum(r["mismatched_rows"] for r in rows)
    return rows, summary


def encoder_items(rng, budget: int, silent_fraction: float = 0.0,
                  frames=(130, 260)):
    """Numpy-seeded utterances of ``frames`` [lo, hi) 50 Hz frames (by
    default the synthetic corpus's lengths) up to ``budget`` EMG samples;
    silent ones get targets of another length, as a silent recording's
    parallel voiced targets have."""
    from ste_gan_torch import constants as C

    items, total = [], 0
    while True:
        n = int(rng.integers(*frames))
        if total + 16 * n > budget:
            return items
        silent = bool(rng.random() < silent_fraction)
        target = int(rng.integers(*frames)) if silent else n
        items.append({
            C.DataType.REAL_EMG: np.tanh(rng.normal(
                0, 0.5, (16 * n, 8))).astype(np.float32),
            C.DataType.SPEECH_UNITS: rng.normal(
                size=(target, 256)).astype(np.float32),
            C.DataType.PHONEMES: rng.integers(0, 48, target).astype(np.int32),
            C.DataType.SPEAKING_MODE_ID: (C.SpeakingMode.SILENT if silent
                                          else C.SpeakingMode.NORMAL)})
        total += 16 * n


def silent_fold_dims(items):
    """The fold's silent slot arguments for ``items`` (empty: none)."""
    from ste_gan_torch import constants as C

    silent = [it for it in items
              if it[C.DataType.SPEAKING_MODE_ID] != C.SpeakingMode.NORMAL]
    if not silent:
        return {}
    return {"max_silent": len(silent),
            "silent_target_frames": max(len(it[C.DataType.PHONEMES])
                                        for it in silent),
            "silent_pred_frames": max(len(it[C.DataType.REAL_EMG]) // 16
                                      for it in silent)}


def encoder_reference_steps(torch, tenc, base, batches, t_pred: int,
                            device: str):
    """Losses of train steps of a copy of ``base`` on ``device``, one per
    batch, from the same seeded state (so the same shifts)."""
    import copy

    model = copy.deepcopy(base).to(device)
    state = tenc.init_train_state(model)
    step = tenc.make_encoder_train_step(model, 16, silent_pred_frames=t_pred)
    losses = []
    for batch in batches:
        tenc.set_learning_rate(state.opt, 1e-3)
        _, metrics = step(state, {k: torch.from_numpy(np.asarray(v)).to(device)
                                  for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses


def check_encoder_reference(torch, tenc, init_emg_encoder, Config):
    """Two narrow f32 encoder train steps, voiced and mixed, through the
    kernels on the card and the plain versions on the CPU, same weights,
    batches and shifts (dropout 0, TF32 off). Tolerance rtol 1e-3."""
    from ste_gan_torch.train.encoder_data import fold_encoder_batch

    cfg = Config()
    cfg.emg_encoder.params = {"model_size": 32, "num_transformer_layers": 1,
                              "num_heads": 4, "dim_feedforward": 64,
                              "dropout": 0.0}
    base = init_emg_encoder(cfg, torch.float32,
                            torch.Generator().manual_seed(0))
    out = {}
    for mode, fraction in (("voiced", 0.0), ("mixed", 0.5)):
        rng = np.random.default_rng(3 if mode == "voiced" else 4)
        batches = []
        for _ in range(2):
            items = encoder_items(rng, 6400, fraction, frames=(30, 70))
            batches.append(fold_encoder_batch(
                items, n_win=4, max_samples=16,
                **silent_fold_dims(items)).as_dict())
        t_pred = int(max(b.get("silent_pred_len", np.zeros(1)).max()
                         for b in batches))
        if mode == "mixed" and t_pred == 0:
            raise SystemExit("the mixed batches hold no silent sample")
        results = {device: {f"{mode} step {i}": v for i, v in enumerate(
            encoder_reference_steps(torch, tenc, base, batches, t_pred,
                                    device))}
                   for device in ("cuda", "cpu")}
        out[mode] = {"worst_rel": worst_relative(results, f"narrow {mode} "
                                                           f"encoder step"),
                     **results}
    print(f"[encoder] narrow f32 encoder steps, cuda vs cpu: worst relative "
          f"loss difference voiced {out['voiced']['worst_rel']:.3e}, mixed "
          f"{out['mixed']['worst_rel']:.3e} (tol 1e-3)", flush=True)
    return out


def time_encoder_step(torch, tenc, model, batch, silent_pred_frames=0,
                      warmup=3, timed=10):
    state = tenc.init_train_state(model)
    step = tenc.make_encoder_train_step(model, 160, silent_pred_frames)
    tenc.set_learning_rate(state.opt, 3e-4)
    losses = []
    for _ in range(warmup):
        _, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        _, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / timed, [float(x) for x in losses]


def check_encoder_step(torch, tenc, fa, dtw, load_config, init_emg_encoder,
                       card):
    """The bare encoder train step at full width
    (``configs/emg_encoder/conv_transformer.yaml``: 768 wide, 4 ResBlocks,
    6 layers, FFN 3072, dropout 0.2) on numpy-seeded folded batches of 80
    windows (the 128k-sample packing budget), 3 warm-up and 10 timed steps
    each: a voiced batch with PyTorch's default precision settings (cuDNN
    convolutions in TF32, matrix products in f32: what the trainer CLI
    gets), the same with TF32 off, and a mixed batch (a quarter of the
    utterances silent) with the mixed corpus's DTW dimensions (24 silent
    slots, 259 target and 259 prediction frames) and the defaults. Every
    loss finite; AdamW launched once per step, DTW once per mixed step.
    Then AdamW at the encoder's parameter set against its plain version."""
    from ste_gan_torch import constants as C
    from ste_gan_torch.train.encoder_data import fold_encoder_batch

    cfg = load_config(emg_enc_cfg=str(ROOT / "configs" / "emg_encoder"
                                      / "conv_transformer.yaml"))
    model = init_emg_encoder(cfg, torch.float32,
                             torch.Generator().manual_seed(0)).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    mixed_dims = {"max_silent": 24, "silent_target_frames": 259,
                  "silent_pred_frames": 259}
    batches = {}
    for mode, fraction, dims in (("voiced", 0.0, {}),
                                 ("mixed", 0.25, mixed_dims)):
        items = encoder_items(np.random.default_rng(8), 128_000, fraction)
        n_silent = sum(it[C.DataType.SPEAKING_MODE_ID] != C.SpeakingMode.NORMAL
                       for it in items)
        if mode == "mixed" and not 0 < n_silent <= 24:
            raise SystemExit(f"the mixed batch holds {n_silent} silent "
                             f"utterances, not 1-24")
        host = fold_encoder_batch(items, n_win=80, max_samples=160,
                                  **dims).as_dict()
        batches[mode] = ({k: torch.from_numpy(np.asarray(v)).cuda()
                          for k, v in host.items()},
                         sum(len(it[C.DataType.REAL_EMG]) for it in items),
                         len(items), n_silent)
    report = {"params": n_params, "windows": 80, "window_samples": 80 * 1600}
    for name, mode, tf32 in (("default", "voiced", True),
                             ("tf32_off", "voiced", False),
                             ("mixed", "mixed", True)):
        batch, samples, n_items, n_silent = batches[mode]
        t_pred = mixed_dims["silent_pred_frames"] if mode == "mixed" else 0
        torch.backends.cudnn.allow_tf32 = tf32
        fa.fused_adamw_.launches = dtw.dtw_alignment_batched.launches = 0
        torch.cuda.reset_peak_memory_stats()
        sec, losses = time_encoder_step(torch, tenc, model, batch, t_pred)
        steps = len(losses)
        launches = {"fused_adamw": fa.fused_adamw_.launches,
                    "dtw": dtw.dtw_alignment_batched.launches}
        want = {"fused_adamw": steps, "dtw": steps if t_pred else 0}
        bad = [x for x in losses if x != x or abs(x) == float("inf")]
        if bad or launches != want:
            raise SystemExit(f"full-width encoder step ({name}): losses "
                             f"{losses}, launches {launches}, expected {want}")
        report[name] = {"ms_per_step": 1e3 * sec, "emg_samples": samples,
                        "utterances": n_items, "silent_utterances": n_silent,
                        "emg_samples_per_s": samples / sec,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "launches_per_step": {k: v / steps
                                              for k, v in launches.items()},
                        "losses": losses}
        print(f"[encoder-step] full width ({n_params} params), {mode} batch "
              f"of {n_items} utterances ({n_silent} silent) in 80 windows x "
              f"1600 samples ({samples} EMG samples), cuDNN TF32 "
              f"{'on' if tf32 else 'off'}: {1e3 * sec:.2f} ms/step, "
              f"{samples / sec:.1f} EMG samples/s, peak "
              f"{report[name]['peak_gib']:.2f} GiB, launches per step "
              f"{json.dumps(report[name]['launches_per_step'])} ({card})",
              flush=True)
    torch.backends.cudnn.allow_tf32 = False

    # AdamW at the encoder's parameter set: kernel against plain, timed
    # with the library's.
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [p.shape for p in model.parameters()]
    a = report["adamw"] = adamw_row(torch, fa, shapes, gen, lr=3e-4, b1=0.9,
                                    b2=0.999, weight_decay=1e-5)
    print(f"[encoder-step] AdamW over the encoder ({a['params']} params, "
          f"{a['leaves']} leaves): max|err| {a['max_abs_err']:.3e} (tol "
          f"{a['tol']:g}) kernel {a['ms']:.4f} ms plain {a['plain_ms']:.4f} "
          f"ms library {a['library_ms']:.4f} ms bound {a['bound_ms']:.4f} ms "
          f"({a['bound_by']}) ({card})", flush=True)
    return report


def check_encoder_trainer(torch, counters, card):
    """The encoder trainer CLI at full width on the port's synthetic corpus
    (96/24/16 utterances): voiced for 3 epochs, then mixed
    (``--silent_fraction 0.25``, ``--include_silent``) for 2, with the
    launch counts zeroed before each run and read after it. Then
    ``best_val_loss_model.pt`` loads strictly into ``build_models``'s frozen
    encoder through the GAN trainer's ``load_frozen_encoder``. The runs use
    PyTorch's default precision settings, as the CLI does. The run directories
    (``build/chip_smoke_encoder``) stay for [evaluate]."""
    import yaml

    from ste_gan_torch.config import load_config
    from ste_gan_torch.data import synthetic
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.train import encoder as tenc
    from ste_gan_torch.train.gan import build_models
    from ste_gan_torch.train.train_gan import load_frozen_encoder

    work = ROOT / "build" / "chip_smoke_encoder"
    shutil.rmtree(work, ignore_errors=True)
    enc_yaml = ROOT / "configs" / "emg_encoder" / "conv_transformer.yaml"
    torch.backends.cudnn.allow_tf32 = True
    report = {}
    try:
        for mode, data_yaml, fraction, epochs in (
                ("voiced", "synthetic.yaml", "0.0", 3),
                ("mixed", "synthetic_mixed.yaml", "0.25", 2)):
            root = work / f"corpus_{mode}"
            t0 = time.perf_counter()
            synthetic.main(["--root", str(root), "--silent_fraction",
                            fraction])
            corpus_s = time.perf_counter() - t0
            with open(ROOT / "configs" / "data" / data_yaml) as fp:
                data = yaml.safe_load(fp)
            data["dataset_root"] = str(root)
            (work / data_yaml).write_text(yaml.safe_dump(data))
            argv = ["--config", str(ROOT / "configs" / "ste_gan_base_gantts.yaml"),
                    "--data", str(work / data_yaml), "--emg_enc_cfg",
                    str(enc_yaml), "--exp_dir", str(work / "exp"),
                    "--num_epochs", str(epochs)]
            if mode == "mixed":
                argv.append("--include_silent")
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            tenc.main(tenc.parse_args(argv))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            want = ("fused_adamw", "dtw") if mode == "mixed" else ("fused_adamw",)
            missing = [name for name in want if launches[name] <= 0]
            if missing:
                raise SystemExit(f"kernels never launched by the {mode} "
                                 f"encoder trainer: {missing}")
            suffix = "_mixed" if mode == "mixed" else "_voiced_only"
            run = work / "exp" / tenc.create_output_dir_name(
                root, "EMGEncoderTransformer" + suffix)
            for entry in (".done", "config.yaml", "metrics.jsonl",
                          "best_val_loss_model.pt", "last_model.pt"):
                if not (run / entry).exists():
                    raise SystemExit(f"encoder run dir lacks {entry}")
            logged = {}
            for line in (run / "metrics.jsonl").read_text().splitlines():
                rec = json.loads(line)
                logged.setdefault(rec["tag"], []).append(rec["value"])
            losses = logged["train/loss"] + logged["val/loss"]
            if any(x != x or abs(x) == float("inf") for x in losses):
                raise SystemExit(f"non-finite encoder losses: {losses}")
            steps = len(logged["train/loss"])
            report[mode] = {
                "corpus": str(root), "checkpoint": str(
                    run / "best_val_loss_model.pt"),
                "corpus_s": corpus_s, "run_s": run_s, "launches": launches,
                "steps": steps, "train_loss": logged["train/loss"],
                "val_loss": logged["val/loss"],
                "epoch_train_s": logged["perf/epoch_train_s"],
                "validation_s": logged["perf/validation_s"],
                "save_s": logged["perf/save_s"],
                "launches_per_step": {k: v / steps for k, v in launches.items()}}
            print(f"[encoder-trainer] {mode}: {epochs} epochs, {steps} steps "
                  f"in {run_s:.1f} s; launches {launches}; val loss "
                  f"{logged['val/loss']}; epoch train s "
                  f"{json.dumps(logged['perf/epoch_train_s'])}, validation s "
                  f"{json.dumps(logged['perf/validation_s'])}, blocking save s "
                  f"{json.dumps(logged['perf/save_s'])} ({card})", flush=True)

        # The hand-off: the GAN trainer's loader takes the encoder strictly,
        # its weights equal the file's bit for bit, and its outputs equal
        # the saved encoder's (f32, TF32 off; cuDNN may pick another
        # algorithm for another model, so outputs are held to 1e-5 of their
        # largest value, the weights exactly).
        torch.backends.cudnn.allow_tf32 = False
        cfg = load_config(str(ROOT / "configs" / "ste_gan_base_gantts.yaml"),
                          str(work / "synthetic_mixed.yaml"), str(enc_yaml))
        cfg.train.mixed_precision = False
        best = run / "best_val_loss_model.pt"
        models = build_models(cfg, seed=1, device="cuda")
        load_frozen_encoder(models, best)
        state = torch.load(best, weights_only=True)
        same_weights = all(torch.equal(v.cpu(), state[k]) for k, v in
                           models.encoder.state_dict().items())
        saved = init_emg_encoder(cfg, torch.float32).cuda()
        saved.load_state_dict(state, strict=True)
        emg = torch.from_numpy(np.tanh(np.random.default_rng(9).normal(
            0, 0.5, (4, 4096, 8))).astype(np.float32)).cuda()
        with torch.no_grad():
            rel = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(models.encoder(emg), saved(emg)))
        print(f"[encoder-trainer] {best.name} loads strictly into the GAN "
              f"trainer's frozen encoder: weights equal {same_weights}, "
              f"outputs within {rel:.3e} of the saved encoder's (tol 1e-5)",
              flush=True)
        if not same_weights or not rel <= 1e-5:
            raise SystemExit("the GAN trainer's frozen encoder differs from "
                             "the trained one")
        report["handoff"] = {"weights_equal": same_weights,
                             "outputs_max_rel": rel}
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return report


def generator_flops(synth, feats, sess) -> float:
    """Operations of one ``synthesize_batch`` call, counted from the shapes
    the weight-normalised convs see (2 per multiply-add)."""
    from ste_gan_torch.ops.conv import WNConv

    total = [0.0]

    def hook(mod, inputs, out):
        cout, cin_g, k = mod.weight_v.shape
        total[0] += 2.0 * out.shape[0] * out.shape[2] * cout * cin_g * k

    handles = [m.register_forward_hook(hook) for m in synth.generator.modules()
               if isinstance(m, WNConv)]
    try:
        synth.synthesize_batch(feats, sess)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def check_infer(torch, card, corpus):
    """The synthesis and decoding layer (``ste_gan_torch.infer``): the
    narrow f32 synthesizer on the card against the CPU (per-row valid
    lengths, TF32 off); at the full width of
    ``configs/ste_gan_base_gantts.yaml`` (768 channels, speech units) with
    seeded weights, bucketed against exact and streaming interiors against
    the full utterance for 500 frames (f32, TF32 off); the real-time factor
    at batch 1 x 500 frames and at a bucketed batch of 16 x 64 frames in
    f32 with TF32 off and on and in bf16; ``convert_dataset`` over the
    synthetic test split, cold and warm, with PyTorch's default precision
    settings (what ``generate_emg`` gets); and the full-width
    ``EMGDecoder`` (``configs/emg_encoder/conv_transformer.yaml``) on 10 s
    (shorter than one streaming window: the full-decode fallback) and 30 s
    of EMG, streaming against the full decode (TF32 off)."""
    from ste_gan_torch import constants as C
    from ste_gan_torch.config import Config, load_config
    from ste_gan_torch.data.dataset import EMGDataset
    from ste_gan_torch.infer import (EMGDecoder, EMGSynthesizer,
                                     convert_dataset,
                                     decoder_receptive_field_frames)
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.models.generator import init_emg_generator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    report = {}

    # ---- Narrow f32 synthesizer: card against the CPU. ----
    cfg = narrow_config(Config)
    sd = init_emg_generator(cfg, torch.float32,
                            torch.Generator().manual_seed(0)).state_dict()
    feats = rng.normal(size=(4, 96, 256)).astype(np.float32)
    sess = rng.integers(0, cfg.data.num_emg_sessions, 4)
    valid = np.array([96, 80, 41, 7])
    outs = {dev: EMGSynthesizer.from_config(cfg, sd, device=dev)
            .synthesize_padded(feats, sess, np.zeros(4), valid).cpu().numpy()
            for dev in ("cuda", "cpu")}
    rel = max(float(np.abs(outs["cuda"][r, :16 * v] - outs["cpu"][r, :16 * v])
                    .max() / np.abs(outs["cpu"][r, :16 * v]).max())
              for r, v in enumerate(valid))
    print(f"[infer] narrow f32 synthesize_padded (4 rows, valid "
          f"{valid.tolist()}"
          f"), cuda vs cpu: worst relative difference {rel:.3e} (tol "
          f"{TOL['float32']:g})", flush=True)
    if not rel <= TOL["float32"]:
        raise SystemExit("the narrow synthesizer disagrees with the CPU")
    report["narrow_cuda_vs_cpu_rel"] = rel

    # ---- Full width: bucketing and streaming, f32 with TF32 off. ----
    cfg = load_config(str(ROOT / "configs" / "ste_gan_base_gantts.yaml"))
    gen = init_emg_generator(cfg, torch.float32,
                             torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in gen.parameters())
    sd = gen.state_dict()
    exact = EMGSynthesizer.from_config(cfg, sd, bucket=1, device="cuda")
    bucketed = EMGSynthesizer.from_config(cfg, sd, bucket=64, device="cuda")
    utt = rng.normal(size=(500, 256)).astype(np.float32)
    full = exact.synthesize(utt, 1)
    bucket_diff = float(np.abs(bucketed.synthesize(utt, 1) - full).max())
    chunks = list(exact.synthesize_streaming(utt, 1, chunk_frames=128))
    stream = np.concatenate(chunks)
    stream_diff = float(np.abs(stream - full).max())
    print(f"[infer] full width ({n_params} params), 500 frames, f32 TF32 "
          f"off: bucketed (64) vs exact max|diff| {bucket_diff:.3e}; "
          f"streaming ({len(chunks)} chunks of 128 + 2 x 128 context) vs "
          f"full max|diff| {stream_diff:.3e} (tol {INFER_TOL:g}); max|full| "
          f"{np.abs(full).max():.3f}", flush=True)
    if (full.shape != (8000, 8) or stream.shape != full.shape
            or not bucket_diff <= INFER_TOL or not stream_diff <= INFER_TOL):
        raise SystemExit("full-width bucketed or streaming synthesis "
                         "differs from the exact full utterance")
    report.update(params=n_params, bucket_max_abs_diff=bucket_diff,
                  stream_max_abs_diff=stream_diff, tol=INFER_TOL)
    del exact, bucketed

    # ---- Real-time factor. ----
    rtf = report["rtf"] = {}
    for name, dtype, tf32 in (("f32_tf32_off", torch.float32, False),
                              ("f32_tf32_on", torch.float32, True),
                              ("bf16", torch.bfloat16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        synth = EMGSynthesizer.from_config(cfg, sd, bucket=64, dtype=dtype,
                                           device="cuda")
        for shape, (batch, frames) in (("batch1x500", (1, 500)),
                                       ("batch16x64", (16, 64))):
            factor = synth.real_time_factor(num_frames=frames, iters=20,
                                            batch=batch)
            flops = generator_flops(
                synth, torch.zeros((batch, frames, 256), device="cuda"),
                torch.zeros((batch,), dtype=torch.long, device="cuda"))
            call_s = factor * batch * frames / 50.0
            rtf.setdefault(name, {})[shape] = {
                "rtf": factor, "emg_s_per_s": 1.0 / factor,
                "ms_per_call": 1e3 * call_s, "gflop_per_call": flops / 1e9,
                "tflop_per_s": flops / call_s / 1e12}
            print(f"[infer] real-time factor {name} {shape}: {factor:.6f} = "
                  f"{1.0 / factor:.1f} s of EMG per s ({1e3 * call_s:.3f} "
                  f"ms per call, {flops / 1e9:.2f} GFLOP, "
                  f"{flops / call_s / 1e12:.2f} TFLOP/s) ({card})",
                  flush=True)
        del synth
    torch.backends.cudnn.allow_tf32 = False

    # ---- convert_dataset over the synthetic test split. ----
    train = EMGDataset(Path(corpus), "train", filter_by_length=False)
    test = EMGDataset(Path(corpus), "test", filter_by_length=False,
                      session_id_to_idx=train.session_id_to_idx,
                      speaking_mode_id_to_idx=train.speaking_mode_id_to_idx)
    torch.backends.cudnn.allow_tf32 = True
    synth = EMGSynthesizer.from_config(cfg, sd, bucket=64, device="cuda")
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        results = convert_dataset(synth, test, bucket=64)
        passes.append(time.perf_counter() - t0)
    torch.backends.cudnn.allow_tf32 = False
    emg_s = sum(len(r[C.DataType.FAKE_EMG]) for r in results) / 800.0
    report["convert_dataset"] = {"utterances": len(results), "emg_s": emg_s,
                                 "cold_s": passes[0], "warm_s": passes[1],
                                 "warm_emg_s_per_s": emg_s / passes[1]}
    print(f"[infer] convert_dataset, synthetic test split ({len(results)} "
          f"utterances, {emg_s:.1f} s of EMG), f32 with PyTorch's default "
          f"TF32: cold {passes[0]:.3f} s, warm {passes[1]:.3f} s = "
          f"{emg_s / passes[1]:.1f} s of EMG per s ({card})", flush=True)
    del synth

    # ---- The full-width decoder. ----
    ecfg = load_config(emg_enc_cfg=str(ROOT / "configs" / "emg_encoder"
                                       / "conv_transformer.yaml"))
    dec = EMGDecoder(init_emg_encoder(ecfg, torch.float32,
                                      torch.Generator().manual_seed(0)),
                     device="cuda")
    ctx = decoder_receptive_field_frames(dec.model)
    report["decoder"] = {"receptive_field_frames": ctx}
    for seconds in (10, 30):
        emg = np.tanh(rng.normal(0, 0.5, (800 * seconds, 8))).astype(
            np.float32)
        dec.decode(emg)  # first call at this shape
        t0 = time.perf_counter()
        units, ph = dec.decode(emg)
        full_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        chunks = list(dec.decode_streaming(emg, chunk_frames=100))
        stream_ms = 1e3 * (time.perf_counter() - t0)
        fallback = 50 * seconds <= 100 + 2 * ctx
        rel = max(float(np.abs(np.concatenate([c[i] for c in chunks]) - ref)
                        .max() / np.abs(ref).max())
                  for i, ref in enumerate((units, ph)))
        report["decoder"][f"{seconds}s"] = {
            "decode_ms": full_ms, "decode_streaming_ms": stream_ms,
            "chunks": len(chunks), "full_decode_fallback": fallback,
            "max_rel_diff": rel}
        print(f"[infer] EMGDecoder full width, {seconds} s of EMG: decode "
              f"{full_ms:.2f} ms; decode_streaming (chunks of 100 frames, "
              f"context {ctx}{', full-decode fallback' if fallback else ''})"
              f" {stream_ms:.2f} ms for {len(chunks)} chunks; streamed vs "
              f"full max relative difference {rel:.3e} (tol {DECODE_TOL:g})"
              f" ({card})", flush=True)
        if not rel <= DECODE_TOL:
            raise SystemExit("streaming decode differs from the full decode")
    return report


def _non_finite(tree, path=""):
    """Paths of the non-finite numbers in a report."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _non_finite(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _non_finite(v, f"{path}/{i}")]
    if isinstance(tree, float) and not np.isfinite(tree):
        return [path]
    return []


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text)."""
    import contextlib

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = fn(*args)
    return result, printed.getvalue()


def check_evaluate(torch, dtw, card, gan_run, encoder_runs):
    """The offline evaluation CLI and ``generate_emg`` on the run
    directories that the trainer phases wrote, with PyTorch's default
    precision settings (what the CLIs get): ``evaluate gan --full
    --realism`` (the frozen encoder: the voiced encoder run's
    ``best_val_loss_model.pt``), ``evaluate encoder`` voiced and with
    ``--include_silent`` (the mixed run's encoder and corpus; the DTW
    launch count is zeroed before each and must move in the silent one
    only), every reported number finite; then ``generate_emg`` on the GAN
    run's test split."""
    from ste_gan_torch import evaluate, generate_emg

    enc_yaml = str(ROOT / "configs" / "emg_encoder" / "conv_transformer.yaml")
    out = Path(gan_run).parent.parent / "eval"
    torch.backends.cudnn.allow_tf32 = True
    runs = {
        "gan": ["gan", "--run_dir", gan_run, "--emg_enc_ckpt",
                encoder_runs["voiced"]["checkpoint"], "--full", "--realism"],
        "encoder_voiced": ["encoder", "--ckpt",
                           encoder_runs["voiced"]["checkpoint"],
                           "--data_root", encoder_runs["voiced"]["corpus"],
                           "--emg_enc_cfg", enc_yaml],
        "encoder_silent": ["encoder", "--ckpt",
                           encoder_runs["mixed"]["checkpoint"],
                           "--data_root", encoder_runs["mixed"]["corpus"],
                           "--emg_enc_cfg", enc_yaml, "--include_silent"],
    }
    report = {}
    try:
        for mode, argv in runs.items():
            dtw.dtw_alignment_batched.launches = 0
            t0 = time.perf_counter()
            rep, _ = _quiet(evaluate.main,
                            argv + ["--out", str(out / f"{mode}.json")])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = dtw.dtw_alignment_batched.launches
            bad = _non_finite(rep)
            summary = ({k: rep["chunked"][k] for k in ("val/speech_unit",
                                                       "val/multi_td")}
                       | {"full_phoneme_accuracy":
                          rep["full_utterance"]["phoneme_accuracy"],
                          "full_su_l1": rep["full_utterance"]["su_l1"],
                          "fed": rep["realism"]["fed"],
                          "lsd_db": rep["realism"]["log_spectral_distance"][
                              "mean_db"]}
                       if mode == "gan" else
                       {k: rep[k] for k in ("num_utterances", "loss",
                                            "phoneme_accuracy")})
            report[mode] = {"s": sec, "dtw_launches": launches,
                            "summary": summary, "report": rep}
            print(f"[evaluate] {mode}: {sec:.2f} s; dtw_align_kernel "
                  f"launches {launches}; {json.dumps(summary)}; non-finite "
                  f"{bad} ({card})", flush=True)
            if bad:
                raise SystemExit(f"evaluate {mode}: non-finite numbers {bad}")
            if (launches > 0) != (mode == "encoder_silent"):
                raise SystemExit(f"evaluate {mode}: {launches} DTW launches")

        t0 = time.perf_counter()
        gen, printed = _quiet(generate_emg.main, [
            "--run_dir", gan_run, "--partition", "test", "--out_dir",
            str(out / "emg_synth")])
        sec = time.perf_counter() - t0
        files = len(list((out / "emg_synth").glob("*.npy")))
        report["generate_emg"] = {"s": sec, "files": files, **gen,
                                  "printed": printed}
        said = printed.strip().replace("\n", "; ")
        print(f"[evaluate] generate_emg: {sec:.2f} s; {files} files; {said} "
              f"({card})", flush=True)
        if files != gen["num_utterances"] or not files:
            raise SystemExit("generate_emg wrote no file per utterance")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return report


def check_export(torch, card, gan_run, encoder_runs):
    """Deployment artifacts (``ste_gan_torch.export``, ``quant`` and the
    two export CLIs) from the runs the trainer phases wrote: the generator
    CLI on the GAN run (f32 serving, f32 minimal, int8 serving) and the
    encoder CLI on the voiced encoder (f32, int8), each with ``--verify``;
    the full-width f32 serving artifact against
    ``EMGSynthesizer.synthesize_padded`` on a padded batch with per-row
    valid lengths (TF32 off, ``INFER_TOL``); a narrow artifact exported on
    the CPU, loaded on the card through the device move and held to the
    same generator on the card; one call of the int8 and the f32 serving
    artifact timed, and the dequantisation the int8 program runs per call
    timed alone. Returns the report and the artifacts' paths."""
    from ste_gan_torch import export_emg_encoder, export_generator
    from ste_gan_torch.config import Config
    from ste_gan_torch.export import (ExportedSynthesizer, generator_meta,
                                      save_exported)
    from ste_gan_torch.export import export_generator as export_program
    from ste_gan_torch.infer import EMGSynthesizer
    from ste_gan_torch.models.generator import init_emg_generator
    from ste_gan_torch.quant import dequantize_state_dict, quantize_state_dict
    from ste_gan_torch.serve import load_served_generator

    out = Path(gan_run).parent.parent / "export"
    enc_ckpt = encoder_runs["voiced"]["checkpoint"]
    runs = {
        "generator_f32_serving": (export_generator, [
            "--run_dir", gan_run, "--serving", "--verify"]),
        "generator_f32_minimal": (export_generator, [
            "--run_dir", gan_run, "--verify"]),
        "generator_int8_serving": (export_generator, [
            "--run_dir", gan_run, "--serving", "--quantize", "int8",
            "--verify"]),
        "encoder_f32": (export_emg_encoder, ["--ckpt", enc_ckpt, "--verify"]),
        "encoder_int8": (export_emg_encoder, [
            "--ckpt", enc_ckpt, "--quantize", "int8", "--verify"]),
    }
    report, paths = {}, {}
    for name, (cli, argv) in runs.items():
        paths[name] = out / f"{name}.pt2"
        t0 = time.perf_counter()
        rep, printed = _quiet(cli.main, argv + ["--out", str(paths[name])])
        torch.cuda.synchronize()
        rep.update(total_s=time.perf_counter() - t0, printed=printed)
        report[name] = rep
        extra = {k: v for k, v in rep.items() if k.startswith("int8_")}
        print(f"[export] {name}: export {rep['export_s']:.2f} s (CLI "
              f"{rep['total_s']:.2f} s), {rep['bytes'] / 1e6:.2f} MB, "
              f"verify max|artifact - framework| "
              f"{rep['verify']['max_abs_diff']:.3e} (tol "
              f"{rep['verify']['tol']:g}){' ' + json.dumps(extra) if extra else ''}"
              f" ({card})", flush=True)
    for kind in ("generator", "encoder"):
        f32 = report[f"{kind}_f32" + ("_serving" if kind == "generator"
                                      else "")]["bytes"]
        int8 = report[f"{kind}_int8" + ("_serving" if kind == "generator"
                                        else "")]["bytes"]
        report[f"{kind}_int8_over_f32_bytes"] = int8 / f32
        print(f"[export] {kind} artifact: f32 {f32 / 1e6:.2f} MB, int8 "
              f"{int8 / 1e6:.2f} MB ({int8 / f32:.3f}x)", flush=True)

    # ---- The full-width f32 serving artifact against the synthesizer. ----
    cfg, _, state_dict = load_served_generator(gan_run, "best", "cuda")
    ref = EMGSynthesizer.from_config(cfg, state_dict, dtype=torch.float32,
                                     device="cuda")
    art = ExportedSynthesizer(paths["generator_f32_serving"])
    rng = np.random.default_rng(13)
    valid = np.array([128, 100, 37, 5])
    feats = rng.normal(size=(4, 128, 256)).astype(np.float32)
    sess = rng.integers(0, cfg.data.num_emg_sessions, 4)
    mode = np.zeros(4, np.int64)
    got = art.synthesize_padded(feats, sess, mode, valid).cpu().numpy()
    want = ref.synthesize_padded(feats, sess, mode, valid).cpu().numpy()
    diff = max(float(np.abs(got[r, :16 * v] - want[r, :16 * v]).max())
               for r, v in enumerate(valid))
    print(f"[export] full-width f32 serving artifact vs "
          f"EMGSynthesizer.synthesize_padded (4 rows, valid "
          f"{valid.tolist()}, TF32 off): max|diff| {diff:.3e} (tol "
          f"{INFER_TOL:g})", flush=True)
    if not diff <= INFER_TOL:
        raise SystemExit("the f32 serving artifact differs from the "
                         "synthesizer")
    report["serving_vs_synthesizer_max_abs_diff"] = diff

    # ---- A narrow artifact traced on the CPU, run on the card. ----
    ncfg = narrow_config(Config)
    gen = init_emg_generator(ncfg, torch.float32,
                             torch.Generator().manual_seed(0)).eval()
    narrow = out / "narrow-cpu-serving.pt2"
    save_exported(export_program(gen, 256, serving=True), narrow,
                  generator_meta(gen, 256, True))
    traced = json.loads(Path(str(narrow) + ".meta.json").read_text())["device"]
    moved = ExportedSynthesizer(narrow)
    on = {str(v.device) for v in moved._program.state_dict().values()}
    if on != {"cuda:0"}:
        raise SystemExit(f"the CPU-traced artifact lies on {on}")
    nfeats = rng.normal(size=(3, 40, 256)).astype(np.float32)
    nvalid = np.array([40, 23, 6])
    nsess, nmode = np.array([0, 1, 2]), np.zeros(3, np.int64)
    got = moved.synthesize_padded(nfeats, nsess, nmode, nvalid).cpu().numpy()
    want = EMGSynthesizer.from_config(ncfg, gen.state_dict(), device="cuda") \
        .synthesize_padded(nfeats, nsess, nmode, nvalid).cpu().numpy()
    rel = max(float(np.abs(got[r, :16 * v] - want[r, :16 * v]).max()
                    / np.abs(want[r, :16 * v]).max())
              for r, v in enumerate(nvalid))
    print(f"[export] narrow artifact traced on {traced}, loaded on "
          f"{moved.device} through move_to_device_pass: worst relative "
          f"difference from the generator on the card {rel:.3e} (tol "
          f"{TOL['float32']:g})", flush=True)
    if not rel <= TOL["float32"]:
        raise SystemExit("the moved artifact disagrees with the card")
    report["narrow_moved"] = {"traced_on": traced, "max_rel": rel}

    # ---- One call of the int8 and the f32 serving artifact. ----
    int8 = ExportedSynthesizer(paths["generator_int8_serving"])
    bfeats = torch.from_numpy(rng.normal(size=(8, 64, 256)).astype(
        np.float32)).cuda()
    ids = torch.zeros((8,), dtype=torch.long, device="cuda")
    bvalid = torch.full((8,), 64, device="cuda")
    calls = {name: cuda_time(lambda s=s: s.synthesize_padded(
        bfeats, ids, ids, bvalid), reps=20, warmup=3)
        for name, s in (("f32", art), ("int8", int8), ("synthesizer", ref))}
    qsd = quantize_state_dict(state_dict)
    calls["dequantize_only"] = cuda_time(lambda: dequantize_state_dict(qsd),
                                         reps=20, warmup=3)
    report["call_ms_8x64"] = calls
    print(f"[export] one serving call, 8 x 64 frames, f32 TF32 off: f32 "
          f"artifact {calls['f32']:.3f} ms, int8 artifact "
          f"{calls['int8']:.3f} ms (+{calls['int8'] - calls['f32']:.3f} ms: "
          f"its per-call dequantisation; the dequantisation alone "
          f"{calls['dequantize_only']:.3f} ms), EMGSynthesizer "
          f"{calls['synthesizer']:.3f} ms ({card})", flush=True)
    return report, paths


def check_serve(torch, card, gan_run, encoder_runs, artifact):
    """The HTTP service (``ste_gan_torch.serve``) at full width:
    ``serve_load`` (8 clients x 50 requests of 64 frames, ``max_batch`` 8,
    ``max_wait_ms`` 5, bucket 64) on the GAN run's best checkpoint and on
    the f32 serving artifact; then one f32 server (TF32 off) from the run's
    ``checkpoint-00000003`` with the voiced encoder's checkpoint behind
    ``/decode``: ten decodes of 10 s of EMG, one ``/synthesize_stream`` of
    a 500-frame utterance against the full synthesis, and a ``/reload``
    to ``checkpoint-final`` under the same load, which no request may
    fail, after which the served weights must equal the checkpoint's."""
    from ste_gan_torch import serve_load
    from ste_gan_torch.config import load_config
    from ste_gan_torch.infer import EMGDecoder
    from ste_gan_torch.serve import (EMGDecoderService, SynthesisService,
                                     load_served_generator, make_http_server)

    load_args = ["--clients", "8", "--requests", "50", "--frames", "64",
                 "--max_batch", "8", "--max_wait_ms", "5"]
    report = {}
    for name, source in (("run_dir", ["--run_dir", gan_run, "--tag", "best"]),
                         ("artifact", ["--artifact", str(artifact)])):
        rep, _ = _quiet(serve_load.main, source + load_args + [
            "--out", str(ROOT / "chiprun_out" / f"serve_load_{name}.json")])
        report[name] = rep
        lat, st = rep["client_latency_ms"], rep["server_stats"]
        print(f"[serve] serve_load from the {name} (8 clients x 50 x 64 "
              f"frames, max_batch 8, 5 ms): client p50/p95/p99 "
              f"{lat['p50']:.2f}/{lat['p95']:.2f}/{lat['p99']:.2f} ms, "
              f"server p50/p95/p99 {st['latency_ms_p50']:.2f}/"
              f"{st['latency_ms_p95']:.2f}/{st['latency_ms_p99']:.2f} ms, "
              f"batch occupancy {st['batch_occupancy_mean']:.2f} (max "
              f"{st['batch_occupancy_max']}), 503s {rep['rejected_503']}, "
              f"{rep['requests_per_s']:.1f} requests/s, "
              f"{rep['emg_seconds_per_s']:.1f} s of EMG per s ({card})",
              flush=True)
        if rep["errors"] or rep["completed"] != 400:
            raise SystemExit(f"serve_load {name}: {rep['completed']} of 400 "
                             f"answered; errors {rep['errors'][:3]}")

    cfg = load_config(config=Path(gan_run) / "config.yaml")
    # f32 (TF32 off), so that the stream is held to INFER_TOL.
    service = SynthesisService.from_run_dir(gan_run, tag="checkpoint-00000003",
                                            max_batch=8, max_wait_ms=5.0,
                                            bucket=64, dtype=torch.float32)
    decoder = EMGDecoderService.from_checkpoint(
        cfg, encoder_runs["voiced"]["checkpoint"], bucket=64)
    service.warmup(num_frames=64, batch_sizes=(1, 8))
    decoder.warmup()
    server = make_http_server(service, port=0, decoder=decoder)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(17)
    try:
        # ---- /decode: 10 s of EMG (500 frames, padded to 512). ----
        emg = np.tanh(rng.normal(0, 0.5, (8000, 8))).astype(np.float32)
        body = serve_load.npz_payload(emg=emg)
        decode_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            out = np.load(io.BytesIO(serve_load.post(port, "/decode", body)))
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        padded = np.zeros((512 * 16, 8), np.float32)
        padded[:8000] = emg
        want = EMGDecoder.from_checkpoint(
            cfg, encoder_runs["voiced"]["checkpoint"], device="cuda"
        ).decode(padded)
        rel = max(float(np.abs(out[k] - w[:500]).max() / np.abs(w[:500]).max())
                  for k, w in zip(("units", "phoneme_logits"), want))
        report["decode"] = {"ms": decode_ms,
                            "p50_ms": float(np.percentile(decode_ms, 50)),
                            "max_rel_vs_direct": rel}
        print(f"[serve] /decode of 10 s of EMG from the encoder checkpoint "
              f"(bucket 64, 512 frames): p50 "
              f"{report['decode']['p50_ms']:.2f} ms over 10 requests; vs "
              f"the encoder on the same padded input max relative "
              f"difference {rel:.3e} (tol {DECODE_TOL:g}) ({card})",
              flush=True)
        if not rel <= DECODE_TOL:
            raise SystemExit("/decode differs from the encoder")

        # ---- Sessions outside the table: 400, and the card serves on. ----
        feats = rng.normal(size=(64, 256)).astype(np.float32)
        codes = []
        for path in ("/synthesize", "/synthesize_stream"):
            for session in (cfg.data.num_emg_sessions, -1):
                try:
                    serve_load.post(port, path, serve_load.npz_payload(
                        feats=feats, session=session))
                    codes.append(200)
                except urllib.error.HTTPError as exc:
                    codes.append(exc.code)
        after = np.load(io.BytesIO(serve_load.post(
            port, "/synthesize", serve_load.npz_payload(feats=feats,
                                                         session=0))))
        report["out_of_range"] = {"codes": codes,
                                  "then_served": list(after.shape)}
        print(f"[serve] sessions {cfg.data.num_emg_sessions} and -1 on "
              f"/synthesize and /synthesize_stream: HTTP {codes}; the next "
              f"request served {list(after.shape)} ({card})", flush=True)
        if codes != [400] * 4 or not np.isfinite(after).all():
            raise SystemExit("an out-of-range session was not refused")

        # ---- /synthesize_stream of 500 frames against the full one. ----
        feats = rng.normal(size=(500, 256)).astype(np.float32)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize_stream",
            data=serve_load.npz_payload(feats=feats, session=0),
            method="POST")
        chunks = []
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            channels = int(resp.headers["X-Emg-Channels"])
            while True:
                n = int.from_bytes(resp.read(8), "big")
                if n == 0:
                    break
                chunks.append(np.frombuffer(resp.read(n), np.float32)
                              .reshape(-1, channels))
        stream_s = time.perf_counter() - t0
        stream = np.concatenate(chunks)
        full = service.synthesizer.synthesize(feats, 0)
        diff = float(np.abs(stream - full).max())
        report["stream"] = {"chunks": len(chunks), "s": stream_s,
                            "max_abs_diff": diff, "tol": INFER_TOL}
        print(f"[serve] /synthesize_stream, 500 frames in {len(chunks)} "
              f"chunks of 64, {stream_s:.3f} s; vs the full synthesis (f32, "
              f"TF32 off) max|diff| {diff:.3e} (tol {INFER_TOL:g}) ({card})",
              flush=True)
        if stream.shape != full.shape or not diff <= INFER_TOL:
            raise SystemExit("the stream differs from the full synthesis")

        # ---- /reload under load. ----
        load = {}
        payloads = [serve_load.npz_payload(
            feats=rng.normal(size=(64, 256)).astype(np.float32), session=0)
            for _ in range(8)]
        driver = threading.Thread(target=lambda: load.update(
            serve_load.drive(port, payloads, 50)))
        driver.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        info = json.loads(serve_load.post(port, "/reload", json.dumps(
            {"tag": "checkpoint-final"}).encode()))
        reload_s = time.perf_counter() - t0
        driver.join(timeout=600)
        served = service.synthesizer.generator.state_dict()
        _, _, final = load_served_generator(gan_run, "checkpoint-final",
                                            "cuda")
        _, _, first = load_served_generator(gan_run, "checkpoint-00000003",
                                            "cuda")
        equal = all(torch.equal(served[k], final[k]) for k in final)
        moved_weights = any(not torch.equal(first[k], final[k])
                            for k in final)
        lat = serve_load.percentiles(load.get("latencies_ms", []))
        report["reload"] = {"s": reload_s, "info": info,
                            "completed": len(load.get("latencies_ms", [])),
                            "rejected_503": load.get("rejected_503"),
                            "errors": load.get("errors"),
                            "client_latency_ms": lat,
                            "weights_equal_checkpoint": equal,
                            "checkpoints_differ": moved_weights}
        print(f"[serve] /reload checkpoint-00000003 -> checkpoint-final "
              f"under 8 x 50 requests: reload {reload_s:.2f} s; "
              f"{report['reload']['completed']} of 400 answered, 503s "
              f"{load.get('rejected_503')}, errors {load.get('errors')}; "
              f"client p50/p99 {lat.get('p50', 0):.2f}/"
              f"{lat.get('p99', 0):.2f} ms; served weights equal the "
              f"checkpoint's {equal} (the two checkpoints differ: "
              f"{moved_weights}) ({card})", flush=True)
        if (driver.is_alive() or load.get("errors") or load.get("rejected_503")
                or report["reload"]["completed"] != 400 or not equal
                or not moved_weights or info.get("reloads") != 1):
            raise SystemExit("a request failed during /reload, or the served "
                             "weights are not the checkpoint's")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as resp:
            report["stats"] = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    return report


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), for the recurrence
    kernels' chain bounds."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def filtfilt_bound(iir, lengths, stages, latency):
    """The least time of one ``filtfilt_cascade`` call, from its inputs:

    * the chain: every sample of a pass waits for the previous one's state,
      three dependent f64 operations each (``y = z0 + b0 x``, ``y a1``,
      ``z1' - y a1``), over ``n + 2p`` samples, two passes, every stage, for
      the longest row; at the probe's cycles per dependent f64 operation and
      the card's maximum SM clock;
    * bytes: each row read once and written once (8 bytes a sample);
    * operations: ``2 + 4 (N - 1)`` f64 operations per sample and pass of
      an ``N``-tap stage, over every row, at the f64 peak.

    Returns (bound ms, "chain", "bytes" or "operations", the chain's steps,
    the three times in ms)."""
    _, taps, pads = iir.prepare_stages(stages)
    steps = max(sum(2 * (n + 2 * int(p)) for p in pads) for n in lengths)
    chain_ms = (1e3 * 3 * steps * latency["cycles"]["f64_op"]
                / latency["clock_hz"])
    ops = sum(2 * (n + 2 * int(p)) * (2 + 4 * (int(t) - 1))
              for n in lengths for t, p in zip(taps, pads))
    best, kind = bound_ms(16.0 * sum(lengths), ops, "float64", chain_ms)
    return best, kind, steps, {
        "chain_ms": chain_ms, "bytes_ms": 1e3 * 16.0 * sum(lengths)
        / HBM_BYTES_PER_S, "ops_ms": 1e3 * ops / PEAK_OPS_PER_S["float64"]}


def emg_chain_stages():
    """The prep's notch-plus-drift cascade at 1 kHz (eight stages)."""
    from ste_gan_torch.etl import emg_dsp

    return emg_dsp.notch_designs(60, 1000) + [emg_dsp.drift_design(1000)]


def check_etl(torch, iir, card, latency):
    """``filtfilt_kernel`` against its plain version on the card at the
    prep's shapes: 8 rows of 15,000 samples (a 5 s utterance at 1 kHz with
    its two neighbours) through the eight-stage notch-plus-drift cascade,
    8 rows of 4,000 (5 s at 800 Hz) through the Hilbert envelope's 20 Hz
    low-pass, 512 rows of mixed lengths (1,000-4,000) through the cascade
    (all three resident in shared memory), and 8 rows of 40,000 through the
    cascade, past a block's shared memory (streamed). The kernel must equal
    its plain version bit for bit (max |difference| 0, fatal); kernel ms
    (CUDA events), plain ms (one call), bound ms. Then the MFCC frontend
    and ``get_emg_features`` on the card against the port's CPU run."""
    from ste_gan_torch.etl import audio_dsp, emg_dsp, filters

    rng = np.random.default_rng(11)
    lowpass = [filters.butter(4, 20, fs=800, btype="low")]
    cases = [("emg chain, 8 x 15000", [15_000] * 8, emg_chain_stages(), rng),
             ("hilbert low-pass, 8 x 4000", [4_000] * 8, lowpass, rng),
             ("batch of 512 mixed lengths",
              [int(n) for n in rng.integers(1_000, 4_001, 512)],
              emg_chain_stages(), rng),
             ("emg chain, 8 x 40000 (streamed)", [40_000] * 8,
              emg_chain_stages(), np.random.default_rng(13))]
    rows = []
    for name, lengths, stages, data_rng in cases:
        width = max(lengths)
        x = (data_rng.normal(0.0, 20.0, (len(lengths), width)) + 40.0
             + 200.0 * np.sin(np.arange(width) / 60.0))
        xs = torch.from_numpy(x).cuda()
        t0 = time.perf_counter()
        want = iir.filtfilt_cascade_plain(xs, lengths, stages)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got = iir.filtfilt_cascade(xs, lengths, stages)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        b_ms, b_by, steps, parts = filtfilt_bound(iir, lengths, stages,
                                                  latency)
        plan = iir.plan_filtfilt(width, int(iir.prepare_stages(stages)[2].max()))
        row = {"case": name, "rows": len(lengths), "samples": sum(lengths),
               "stages": len(stages), "max_abs_err": err, "tol": 0.0,
               "variant": "resident" if plan.resident else "streamed",
               "smem_bytes": plan.smem_bytes, "chunks": plan.chunks,
               "ms": cuda_time(
                   lambda: iir.filtfilt_cascade(xs, lengths, stages)),
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "chain_steps": steps, "library_ms": None, **parts}
        rows.append(row)
        print(f"[etl] filtfilt_kernel {name}, {len(stages)} stages "
              f"({row['variant']}, {plan.smem_bytes} B of shared memory): "
              f"max|diff| {err!r} (must be 0); kernel {row['ms']:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{steps} samples x 3 dependent f64 ops = "
              f"{parts['chain_ms']:.4f} ms at "
              f"{latency['cycles']['f64_op']:.3f} cycles and "
              f"{latency['clock_hz'] / 1e9:.3f} GHz; bytes "
              f"{parts['bytes_ms']:.5f} ms; ops {parts['ops_ms']:.5f} ms) "
              f"({card})", flush=True)
        if err != 0.0:
            raise SystemExit(f"filtfilt_kernel disagrees with its plain "
                             f"version: {row}")
    summary = {k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)

    # The MFCC frontend and the EMG features on the card against the CPU.
    audio = torch.from_numpy(0.1 * rng.normal(size=5 * 16_000))
    calc = audio_dsp.MFCCsCalculator(device="cuda")
    got = calc(audio)
    want = audio_dsp.MFCCsCalculator(device="cpu")(audio)
    mfcc_err = float((got.cpu() - want).abs().max())
    mfcc_ok = bool(torch.allclose(got.cpu(), want, rtol=2e-4, atol=5e-3))
    mfcc_ms = cuda_time(lambda: calc(audio.cuda()))
    emg = rng.normal(0.0, 20.0, (4_000, 8))
    feats = emg_dsp.get_emg_features(torch.from_numpy(emg).cuda(), pad=True)
    feats_cpu = emg_dsp.get_emg_features(torch.from_numpy(emg), pad=True)
    feats_err = float((feats.cpu() - feats_cpu).abs().max())
    feats_ok = bool(torch.allclose(feats.cpu(), feats_cpu, rtol=1e-5,
                                   atol=1e-6))
    print(f"[etl] MFCC of 5 s on the card vs the CPU: max|diff| "
          f"{mfcc_err:.3e} (rtol 2e-4, atol 5e-3) {mfcc_ok}, {mfcc_ms:.3f} ms "
          f"per call; get_emg_features of 5 s x 8 channels: max|diff| "
          f"{feats_err:.3e} (rtol 1e-5, atol 1e-6) {feats_ok} ({card})",
          flush=True)
    if not (mfcc_ok and feats_ok):
        raise SystemExit("the MFCC or the EMG features differ between the "
                         "card and the CPU")
    return {"filtfilt": rows, "mfcc_max_abs_diff": mfcc_err,
            "mfcc_ms": mfcc_ms, "emg_feats_max_abs_diff": feats_err}, summary


class HubertStandIn:
    """A fixed random projection in place of Soft HuBERT, on the card:
    50 Hz / 256-dim units from 320-sample windows, the HuBERT contract
    ``units(audio [1, 1, T] f32) -> [1, T // 320, 256]`` (the projection of
    tests/test_etl_scripts.py's stub, in torch)."""

    def __init__(self, torch, device, seed: int = 0):
        self._mix = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(320, 256)).astype(np.float32)).to(device)

    def units(self, audio):
        audio = audio.reshape(-1)
        frames = audio.shape[0] // 320
        return (audio[: frames * 320].reshape(frames, 320) @ self._mix)[None]


def _textgrid(duration: float, phones) -> str:
    edges = np.linspace(0.0, duration, len(phones) + 1)
    intervals = "\n".join(
        f"        intervals [{i + 1}]:\n            xmin = {edges[i]:.4f}\n"
        f"            xmax = {edges[i + 1]:.4f}\n            text = \"{ph}\""
        for i, ph in enumerate(phones))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
            f'xmax = {duration:.4f}\ntiers? <exists>\nsize = 1\nitem []:\n'
            '    item [1]:\n        class = "IntervalTier"\n'
            f'        name = "phones"\n        xmin = 0\n'
            f'        xmax = {duration:.4f}\n'
            f'        intervals: size = {len(phones)}\n{intervals}\n')


def write_raw_tree(root: Path, rng, per_session: int = 16):
    """A raw Gaddy & Klein tree at the corpus's shapes: a voiced-parallel,
    a silent-parallel (book locations matching the voiced ones, the first
    dev, the second test) and a nonparallel session of ``per_session``
    utterances of 3-8 s each, plus silence clip 0 in each: 8-channel 1 kHz
    f64 EMG, 16 kHz float32 audio, info JSON and TextGrids (as
    tests/test_etl_scripts.py builds them, longer and more). Returns the
    seconds of EMG written, noise clips excluded."""
    from ste_gan_torch.etl.audio_dsp import write_audio_file

    src, align = root / "emg_data", root / "text_alignments"
    phones = ["sil", "hh", "ah", "l", "ow", "w", "er", "l", "d", "sil"]
    durations = rng.uniform(3.0, 8.0, per_session).round(2)
    total = 0.0
    for kind, book, first in (("voiced_parallel_data", "book1", 10),
                              ("silent_parallel_data", "book1", 10),
                              ("nonparallel_data", "book2", 500)):
        session = src / kind / f"{kind.split('_')[0]}_sess"
        session.mkdir(parents=True)
        (align / session.name).mkdir(parents=True, exist_ok=True)
        utts = [(0, "", -1, 1.0)] + [
            (i + 1, f"utterance {i}", first + i, float(durations[i]))
            for i in range(per_session)]
        for index, text, sentence, duration in utts:
            n_audio, n_emg = int(duration * 16_000), int(duration * 1000)
            tone = 0.3 * np.sin(2 * np.pi * 220 * np.arange(n_audio) / 16_000)
            noise = 0.02 * rng.normal(size=n_audio)
            audio = noise if sentence < 0 else tone + noise
            write_audio_file(session / f"{index}_audio.flac",
                             audio.astype(np.float32), 16_000)
            np.save(session / f"{index}_emg.npy",
                    rng.normal(0.0, 20.0, (n_emg, 8)))
            (session / f"{index}_info.json").write_text(json.dumps(
                {"text": text, "book": book, "sentence_index": sentence}))
            if sentence >= 0:
                total += duration
                (align / session.name / f"{session.name}_{index}_audio"
                 f".TextGrid").write_text(_textgrid(duration, phones))
    (root / "testset_largedev.json").write_text(json.dumps(
        {"dev": [["book1", 10]], "test": [["book1", 11]]}))
    return total


def check_prep(torch, iir, card, etl):
    """``clean_audio`` then ``prep_data`` on the card over a synthetic raw
    tree at the corpus's shapes (three sessions, 48 utterances of 3-8 s),
    with a HuBERT stand-in on the card: the invariants, the split routing,
    a load with the port's dataset, ``filtfilt_kernel`` launches (zeroed
    just before the prep), seconds of EMG per second and ms per utterance;
    then the prep on the card and with ``device="cpu"`` agree for the two
    shortest voiced utterances."""
    from ste_gan_torch import clean_audio, prep_data
    from ste_gan_torch.constants import DataType, SpeakingMode
    from ste_gan_torch.data.dataset import EMGDataset

    work = ROOT / "build" / "chip_smoke_prep"
    shutil.rmtree(work, ignore_errors=True)
    try:
        emg_s = write_raw_tree(work, np.random.default_rng(12))
        t0 = time.perf_counter()
        cleaned = clean_audio.main(["--source_data_dir",
                                    str(work / "emg_data")])
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        stand_in = HubertStandIn(torch, "cuda")
        saved_loader = prep_data.load_hubert
        prep_data.load_hubert = lambda *a, **k: stand_in
        common = ["--source_data_dir", str(work / "emg_data"),
                  "--text_alignment_dir", str(work / "text_alignments"),
                  "--testset_file", str(work / "testset_largedev.json")]
        try:
            iir.filtfilt_cascade.launches = 0
            t0 = time.perf_counter()
            written = prep_data.main([*common, "--target_dir",
                                      str(work / "corpus")])
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            launches = iir.filtfilt_cascade.launches
        finally:
            prep_data.load_hubert = saved_loader
        if launches <= 0:
            raise SystemExit("filtfilt_kernel never launched by the prep")

        target = work / "corpus"
        counts, problems = {}, []
        for split in ("train", "valid", "test"):
            ids = sorted(p.stem for p in (target / split / "emg").glob("*.npy"))
            counts[split] = len(ids)
            for utt in ids:
                emg = np.load(target / split / "emg" / f"{utt}.npy")
                units = np.load(target / split / "units" / f"{utt}.npy")
                feats = np.load(target / split / "emg_feats" / f"{utt}.npy")
                mfccs = np.load(target / split / "mfccs" / f"{utt}.npy")
                phon = np.load(target / split / "phonemes" / f"{utt}.npy")
                ok = (len(mfccs) == 2 * len(units) == 2 * len(phon)
                      and emg.dtype == np.float32 and np.all(np.abs(emg) <= 1)
                      and np.all(np.isfinite(feats)))
                if utt.endswith(SpeakingMode.NORMAL):
                    ok = ok and len(emg) == 16 * len(units) and len(feats) == len(mfccs)
                if not ok:
                    problems.append(f"{split}/{utt}")
        routed = (counts["valid"] == 2 and counts["test"] == 2
                  and counts["train"] == written - 4)
        train = EMGDataset(target, partition="train", strict=True,
                           filter_by_length=False, only_include_voiced=False)
        loaded = len(train) == counts["train"] and train[0][
            DataType.REAL_EMG].shape[1] == 8
        print(f"[prep] clean_audio: {cleaned} files in {clean_s:.2f} s; "
              f"prep_data: {written} utterances ({emg_s:.1f} s of EMG) in "
              f"{prep_s:.2f} s = {emg_s / prep_s:.1f} s of EMG per s, "
              f"{1e3 * prep_s / written:.1f} ms per utterance (the three "
              f"passes of the JAX prep's main: dev, test, all), "
              f"filtfilt_kernel launches {launches} ({etl['filtfilt'][0]['ms']:.3f}"
              f" ms at 8 x 15,000, {etl['filtfilt'][1]['ms']:.3f} ms at 8 x "
              f"4,000), MFCC {etl['mfcc_ms']:.3f} ms per 5 s; splits {counts}, routed "
              f"{routed}, invariants broken by {problems}, dataset load "
              f"{loaded} ({card})", flush=True)
        if problems or not routed or not loaded:
            raise SystemExit("the prepared corpus breaks the prep's "
                             "invariants")

        # Voiced utterances on the card and on the CPU.
        diffs = {}
        kw = dict(silent_dirs=[work / "emg_data" / "silent_parallel_data"],
                  voiced_dirs=[work / "emg_data" / "voiced_parallel_data"],
                  text_align_directory=work / "text_alignments",
                  testset_file=work / "testset_largedev.json",
                  no_testset=True)
        card_prep = prep_data.GaddyKleinPrep(hubert=stand_in, device="cuda", **kw)
        cpu_prep = prep_data.GaddyKleinPrep(
            hubert=HubertStandIn(torch, "cpu"), device="cpu", **kw)
        # The two shortest voiced utterances (with their neighbours, the
        # plain filters on the CPU take seconds each).
        voiced = sorted(
            (i for i, (d, _) in enumerate(card_prep.example_indices)
             if not d.silent),
            key=lambda i: (card_prep.example_indices[i][0].directory /
                           f"{card_prep.example_indices[i][1]}_emg.npy"
                           ).stat().st_size)[:2]
        tols = {"emg": (1e-5, 1e-6), "emg_features": (1e-5, 1e-6),
                "mfccs": (2e-4, 5e-3), "speech_units": (1e-4, 1e-4)}
        ok = True
        for i in voiced:
            a, b = card_prep[i], cpu_prep[i]
            for key, (rtol, atol) in tols.items():
                x, y = a[key].cpu(), b[key]
                diffs.setdefault(key, 0.0)
                diffs[key] = max(diffs[key], float((x - y).abs().max()))
                ok = ok and x.shape == y.shape and bool(torch.allclose(
                    x, y, rtol=rtol, atol=atol))
        print(f"[prep] {len(voiced)} voiced utterances, card vs CPU: max|diff| "
              f"{json.dumps(diffs)} within {json.dumps(tols)}: {ok}",
              flush=True)
        if not ok:
            raise SystemExit("the prep on the card differs from the CPU's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"utterances": written, "emg_s": emg_s, "clean_s": clean_s,
            "prep_s": prep_s, "emg_s_per_s": emg_s / prep_s,
            "ms_per_utterance": 1e3 * prep_s / written,
            "filtfilt_launches": launches, "splits": counts,
            "card_vs_cpu_max_abs_diff": diffs}


def check_moe(torch, tenc, fa, dtw, load_config, init_emg_encoder, Config,
              card, dense_step, encoder_runs, trainer_run):
    """The mixture-of-experts encoder (``conv_transformer_moe.yaml``):
    two narrow MoE train steps, voiced and mixed, on the card and on the
    CPU (rtol 1e-3); the bare step at full width on the 128,000-sample
    budget, voiced and mixed (3 warm-up, 10 timed), with its peak memory
    against the dense step's and against what ``[S, E, C]`` one-hot
    dispatch and combine tensors would add; the encoder CLI with the MoE
    config, voiced and mixed, one epoch each; its checkpoint loaded
    strictly into ``EMGDecoder`` and, as the frozen encoder, into the GAN
    trainer CLI for 3 steps."""
    from ste_gan_torch import constants as C
    from ste_gan_torch.infer import EMGDecoder
    from ste_gan_torch.train import train_gan
    from ste_gan_torch.train.encoder_data import fold_encoder_batch

    report = {}
    # -- narrow reference, card against CPU --
    cfg = Config()
    cfg.emg_encoder.params = {"model_size": 32, "num_transformer_layers": 2,
                              "num_heads": 4, "dim_feedforward": 64,
                              "dropout": 0.0, "moe_experts": 4,
                              "moe_top_k": 2, "moe_capacity_factor": 1.0}
    base = init_emg_encoder(cfg, torch.float32,
                            torch.Generator().manual_seed(0))
    for mode, fraction in (("voiced", 0.0), ("mixed", 0.5)):
        rng = np.random.default_rng(13 if mode == "voiced" else 14)
        batches = []
        for _ in range(2):
            items = encoder_items(rng, 6400, fraction, frames=(30, 70))
            batches.append(fold_encoder_batch(
                items, n_win=4, max_samples=16,
                **silent_fold_dims(items)).as_dict())
        t_pred = int(max(b.get("silent_pred_len", np.zeros(1)).max()
                         for b in batches))
        results = {device: {f"{mode} step {i}": v for i, v in enumerate(
            encoder_reference_steps(torch, tenc, base, batches, t_pred,
                                    device))}
                   for device in ("cuda", "cpu")}
        report[f"narrow_{mode}"] = {"worst_rel": worst_relative(
            results, f"narrow MoE {mode} step"), **results}
    print(f"[moe] narrow f32 MoE encoder steps, cuda vs cpu: worst relative "
          f"loss difference voiced {report['narrow_voiced']['worst_rel']:.3e},"
          f" mixed {report['narrow_mixed']['worst_rel']:.3e} (tol 1e-3)",
          flush=True)

    # -- the full-width step --
    enc_yaml = ROOT / "configs" / "emg_encoder" / "conv_transformer_moe.yaml"
    mcfg = load_config(emg_enc_cfg=str(enc_yaml))
    model = init_emg_encoder(mcfg, torch.float32,
                             torch.Generator().manual_seed(0)).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    moe = model.transformer.layers[0].moe_ffn
    mixed_dims = {"max_silent": 24, "silent_target_frames": 259,
                  "silent_pred_frames": 259}
    tokens = 80 * 1600 // 16
    cap = moe.capacity(tokens)
    one_hot_bytes = 2 * tokens * moe.num_experts * cap * 4 * len(
        model.transformer.layers)
    state_gib = 16.0 * (n_params - dense_step["params"]) / 2**30
    torch.backends.cudnn.allow_tf32 = True
    for mode, fraction, dims in (("voiced", 0.0, {}),
                                 ("mixed", 0.25, mixed_dims)):
        items = encoder_items(np.random.default_rng(8), 128_000, fraction)
        host = fold_encoder_batch(items, n_win=80, max_samples=160,
                                  **dims).as_dict()
        batch = {k: torch.from_numpy(np.asarray(v)).cuda()
                 for k, v in host.items()}
        samples = sum(len(it[C.DataType.REAL_EMG]) for it in items)
        t_pred = dims.get("silent_pred_frames", 0)
        fa.fused_adamw_.launches = dtw.dtw_alignment_batched.launches = 0
        torch.cuda.reset_peak_memory_stats()
        sec, losses = time_encoder_step(torch, tenc, model, batch, t_pred)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad():
            model(batch["emg_windows"], train=True, shift=0,
                  generator=torch.Generator(device="cuda").manual_seed(0))
        aux = float(model.pop_moe_aux_loss())
        dense_peak = dense_step["default" if mode == "voiced" else "mixed"][
            "peak_gib"]
        bad = [x for x in losses + [aux] if x != x or abs(x) == float("inf")]
        launches = {"fused_adamw": fa.fused_adamw_.launches,
                    "dtw": dtw.dtw_alignment_batched.launches}
        row = report[f"full_{mode}"] = {
            "ms_per_step": 1e3 * sec, "emg_samples": samples,
            "emg_samples_per_s": samples / sec, "peak_gib": peak,
            "dense_peak_gib": dense_peak, "one_hot_gib": one_hot_bytes / 2**30,
            "aux_loss": aux, "tokens": tokens, "capacity": cap,
            "expert_state_gib": state_gib,
            "params": n_params, "launches": launches, "losses": losses}
        print(f"[moe] full width ({n_params} params, 6 layers x 4 experts, "
              f"top-2, capacity {cap} of {tokens} tokens), {mode} batch "
              f"({samples} EMG samples), cuDNN TF32 on: {1e3 * sec:.2f} "
              f"ms/step, {samples / sec:.1f} EMG samples/s, peak {peak:.2f} "
              f"GiB (dense step {dense_peak:.2f} GiB; one-hot [S, E, C] "
              f"dispatch and combine would add {one_hot_bytes / 2**30:.2f} "
              f"GiB), aux loss summed over the layers {aux:.4f}, launches {json.dumps(launches)} "
              f"({card})", flush=True)
        if bad or launches["fused_adamw"] != len(losses) or (
                t_pred and launches["dtw"] != len(losses)):
            raise SystemExit(f"full-width MoE step ({mode}): losses {losses}, "
                             f"aux {aux}, launches {launches}")
        # Beyond the dense step: the experts' parameters, gradients and two
        # moments, and the experts' activations; one-hot tensors would add
        # at least half of their size on top.
        extra = peak - dense_peak - state_gib
        row["extra_activation_gib"] = extra
        if not extra < 0.5 * one_hot_bytes / 2**30:
            raise SystemExit(f"the MoE step's peak {peak:.2f} GiB leaves "
                             f"{extra:.2f} GiB beyond the dense step and the "
                             f"experts' state: not far under the one-hot "
                             f"tensors' {one_hot_bytes / 2**30:.2f} GiB")
    del model, batch
    torch.cuda.empty_cache()

    # -- the encoder CLI with the MoE config, then the hand-off --
    work = ROOT / "build" / "chip_smoke_encoder"
    for mode, data_yaml in (("voiced", "synthetic.yaml"),
                            ("mixed", "synthetic_mixed.yaml")):
        argv = ["--config", str(ROOT / "configs" / "ste_gan_base_gantts.yaml"),
                "--data", str(work / data_yaml), "--emg_enc_cfg",
                str(enc_yaml), "--exp_dir", str(work / "exp_moe"),
                "--num_epochs", "1"]
        if mode == "mixed":
            argv.append("--include_silent")
        fa.fused_adamw_.launches = dtw.dtw_alignment_batched.launches = 0
        t0 = time.perf_counter()
        tenc.main(tenc.parse_args(argv))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        suffix = "_mixed" if mode == "mixed" else "_voiced_only"
        run = work / "exp_moe" / tenc.create_output_dir_name(
            Path(encoder_runs[mode]["corpus"]), "EMGEncoderTransformer" + suffix)
        logged = {}
        for line in (run / "metrics.jsonl").read_text().splitlines():
            rec = json.loads(line)
            logged.setdefault(rec["tag"], []).append(rec["value"])
        values = logged["train/loss"] + logged["val/loss"]
        launches = {"fused_adamw": fa.fused_adamw_.launches,
                    "dtw": dtw.dtw_alignment_batched.launches}
        report[f"cli_{mode}"] = {"run_s": run_s, "launches": launches,
                                 "train_loss": logged["train/loss"],
                                 "val_loss": logged["val/loss"],
                                 "checkpoint": str(run / "best_val_loss_model.pt")}
        print(f"[moe] encoder CLI, MoE config, {mode}, 1 epoch: "
              f"{len(logged['train/loss'])} steps in {run_s:.1f} s, val loss "
              f"{logged['val/loss']}, launches {launches} ({card})", flush=True)
        if (any(x != x or abs(x) == float("inf") for x in values)
                or launches["fused_adamw"] <= 0
                or (mode == "mixed" and launches["dtw"] <= 0)
                or not (run / "best_val_loss_model.pt").exists()):
            raise SystemExit(f"MoE encoder CLI ({mode}) failed: {report}")

    best = Path(report["cli_voiced"]["checkpoint"])
    torch.backends.cudnn.allow_tf32 = False
    decoder = EMGDecoder.from_checkpoint(mcfg, best, device="cuda")  # strict
    emg = np.tanh(np.random.default_rng(15).normal(
        0, 0.5, (16_000, 8))).astype(np.float32)
    units, phones = decoder.decode(emg)
    if units.shape != (1000, 256) or not np.all(np.isfinite(units)):
        raise SystemExit(f"EMGDecoder on the MoE checkpoint: {units.shape}")

    trainer_cfg = Path(trainer_run).parent.parent / "config_short.yaml"
    data_yaml = Path(trainer_run).parent.parent / "data.yaml"
    moe_cfg = Path(trainer_run).parent.parent / "config_moe.yaml"
    import yaml

    base = yaml.safe_load(trainer_cfg.read_text())
    base["model_base_dir"] = str(work / "exp_moe_gan")
    moe_cfg.write_text(yaml.safe_dump(base))
    fa.fused_adamw_.launches = 0
    t0 = time.perf_counter()
    train_gan.main(train_gan.parse_args([
        "--config", str(moe_cfg), "--data", str(data_yaml), "--emg_enc_cfg",
        str(enc_yaml), "--emg_enc_ckpt", str(best), "--max_steps", "3"]))
    torch.cuda.synchronize()
    gan_s = time.perf_counter() - t0
    runs = list((work / "exp_moe_gan").iterdir())
    done = len(runs) == 1 and (runs[0] / ".done").exists()
    losses = []
    if done:
        for line in (runs[0] / "metrics.jsonl").read_text().splitlines():
            rec = json.loads(line)
            if rec["tag"].startswith("train_loss/"):
                losses.append(rec["value"])
    finite = bool(losses) and all(x == x and abs(x) != float("inf")
                                  for x in losses)
    report["handoff"] = {"decoder_units": list(units.shape),
                         "gan_steps_s": gan_s, "gan_done": done,
                         "gan_losses_finite": finite,
                         "gan_adamw_launches": fa.fused_adamw_.launches}
    print(f"[moe] {best.name} loads strictly into EMGDecoder (10 s -> "
          f"{units.shape}) and into the GAN trainer as its frozen encoder: "
          f"steps 0-3 in {gan_s:.1f} s, .done {done}, {len(losses)} logged "
          f"losses finite {finite} ({card})", flush=True)
    if not (done and finite):
        raise SystemExit("the GAN trainer did not run with the MoE encoder")
    return report


#: Relative tolerance of two ranks' per-step losses against one rank's at
#: full width in bf16 (see ``check_dist``): the sound two-rank runs read
#: 1.0e-5 to 1.1e-5 over six calls on the H100, reruns of the bare step
#: 1.6e-6 to 9e-6, the control without the gradient all-reduce 9.8e-4.
DIST_LOSS_RTOL = 1e-4
#: Largest ``_weight_deviation`` of a two-rank run's weights from the
#: world-1 DP run's after ``DIST_STEPS`` (see ``check_dist``). On the H100
#: the sound two-rank DP and FSDP runs read 1.47e-2 and 1.48e-2, reruns of
#: the bare step 5.5e-3 (bf16 noise turned by Adam's early, sign-like
#: updates), the control without the gradient all-reduce 0.153 (its loss
#: gap 9.8e-4).
DIST_WEIGHT_RTOL = 0.05
#: Steps of each full-width [dist] run.
DIST_STEPS = 4
#: Reruns of the bare step at world 1: the largest loss gap of a rerun to
#: its first run is the yardstick of the DP and FSDP wrappers (one rerun
#: is a single draw of the bf16 noise and fell to 1.6e-6 where the
#: wrappers read up to 3.4e-6).
BARE_RERUNS = 3
#: The wrappers' loss gap at world 1 may be this many yardsticks.
WORLD1_YARD_FACTOR = 2.0
#: The worker with the gradient all-reduce left out: every rank updates
#: on its own rows' gradients (metrics are still averaged). The control
#: that shows ``DIST_LOSS_RTOL`` catches a rank that skips the all-reduce.
NO_ALLREDUCE_WORKER = (
    "import sys\n"
    "from ste_gan_torch.parallel import mesh\n"
    "mesh.allreduce_grads_ = lambda grads, group, average=True: list(grads)\n"
    "from ste_gan_torch.parallel.multiprocess import main\n"
    "main(sys.argv[1:])\n")


def _dist_env():
    """Environment of the ranks [dist] starts: the checkout importable."""
    return {"PYTHONPATH": str(ROOT)}


def _dist_worker(out: Path, world: int, *flags, timeout: float = 600,
                 no_allreduce: bool = False, code: str = ""):
    """The multi-rank worker CLI on ``world`` ranks of this card (with
    ``no_allreduce``, :data:`NO_ALLREDUCE_WORKER`; ``code``, that control
    program instead); returns the per-rank histories and stats."""
    from ste_gan_torch.parallel.launch import run_ranks

    code = NO_ALLREDUCE_WORKER if no_allreduce else code
    entry = (["-c", code] if code
             else ["-m", "ste_gan_torch.parallel.multiprocess"])
    cmd = [sys.executable, *entry, "--out", str(out), "--timeout_s", "300",
           *flags]
    run_ranks(cmd, world, out / "logs", timeout, env=_dist_env())
    hist = [json.loads((out / f"history_p{r}.json").read_text())
            for r in range(world)]
    stats = [json.loads((out / f"stats_p{r}.json").read_text())
             for r in range(world)]
    return hist, stats


def _loss_gaps(hist, want) -> list:
    """Relative difference of the G and D losses, the larger, per step."""
    return [max(abs(h[k] - w[k]) / abs(w[k]) for k in ("G", "D"))
            for h, w in zip(hist, want)]


def _loss_gap(hist, want) -> float:
    """Largest relative difference of the G and D losses over the steps."""
    return max(_loss_gaps(hist, want))


def _conv_weight(layer):
    """The kernel tensor ``[out, in/G, K]`` a conv layer holds (its slab
    once split)."""
    for name in ("weight_orig", "weight_v", "weight"):
        w = getattr(layer, name, None)
        if hasattr(w, "dim") and w.dim() == 3:
            return w
    raise TypeError(f"no conv kernel on {type(layer).__name__}")


def scale_disc_geometries(gc, disc, chunk: int, rows: int,
                          channels: int) -> list:
    """(B, T, Cin, Cout, K, stride, pad, groups) of every grouped conv the
    scale discriminators of ``disc`` run on ``rows`` stacked rows of
    ``chunk`` samples of ``channels`` channels (scale ``i`` after ``i``
    average pools), read from the layers as they stand: a layer that
    ``tensor_parallel.shard_module_`` split gives this rank's slab (its
    kernel's channels and ``layer.tp.groups``, which may be 1)."""
    out, t = [], chunk
    for i, scale in enumerate(disc.multi_scale_disc):
        if i:
            t = (t + 2 - 4) // 2 + 1  # avg_pool1d(window 4, stride 2, pad 1)
        t_in = t
        for layer in scale.layers:
            k, s, pad = layer.kernel_size[0], layer.stride[0], layer.padding[0]
            if layer.groups > 1:
                w = _conv_weight(layer)
                g = layer.groups if layer.tp is None else layer.tp.groups
                out.append((rows, t_in, w.shape[1] * g, w.shape[0], k, s,
                            pad, g))
            t_in = gc.out_length(t_in, k, s, pad, pad)
    return out


def check_dist_kernels(torch, gc, fa, full):
    """The hand kernels against their plain versions at the shapes [dist]
    gives them beyond the main path's, each fatal on a disagreement:
    forward, dX and dW at the grouped layers of the shipped discriminator
    on 2B = 32 rows (16 per rank over two ranks: the worker and the
    trainer CLI) and of the fleet's tiny one on 16 and 32 rows (two ranks,
    then one), f32 and bf16 at ``TOL``; AdamW (1e-6) over one flat tensor
    the size of each network's FSDP shard at 1 and 2 ranks, and over the
    tiny networks' leaves (the fleet's DP update). ``full``: the shipped
    setup's ``(cfg, models)``. These launches are not counted."""
    from ste_gan_torch.parallel.fsdp import shard_numel
    from ste_gan_torch.parallel.multiprocess import tiny_setup

    t0 = time.perf_counter()
    cfg, models = full
    cfg_t, tiny = tiny_setup("cpu")
    gen = torch.Generator(device="cuda").manual_seed(9)
    geoms = {
        "shipped_2B32": scale_disc_geometries(
            gc, models.discriminator, cfg.train.chunk_size,
            cfg.train.batch_size, cfg.data.num_emg_channels),
        "tiny_2B16_and_2B32": [
            g for rows in (cfg_t.train.batch_size, 2 * cfg_t.train.batch_size)
            for g in scale_disc_geometries(
                gc, tiny.discriminator, cfg_t.train.chunk_size, rows,
                cfg_t.data.num_emg_channels)]}
    conv_rows = [row for label, gs in geoms.items()
                 for row in hold_conv(torch, gc, gs, gen, f"dist-{label}")]
    adamw_rows = []
    hyper = dict(lr=2e-4, b1=0.8, b2=0.99, weight_decay=1e-2)
    for net in ("generator", "discriminator"):
        numels = [p.numel() for p in getattr(models, net).parameters()]
        for ranks in (1, 2):
            n = shard_numel(numels, ranks)
            row = {"network": net, "layout": f"fsdp_shard_{ranks}_ranks",
                   **adamw_row(torch, fa, [(n,)], gen, **hyper)}
            adamw_rows.append(row)
        shapes = [p.shape for p in getattr(tiny, net).parameters()]
        adamw_rows.append({"network": f"tiny_{net}", "layout": "leaves",
                           **adamw_row(torch, fa, shapes, gen, **hyper)})
    for row in adamw_rows:
        print(f"[dist] fused_adamw {row['network']} {row['layout']} "
              f"({row['params']} params, {row['leaves']} leaves): max|err| "
              f"{row['max_abs_err']:.3e} (tol {row['tol']:g}) kernel "
              f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library "
              f"{row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms",
              flush=True)
    summary = {name: {"shapes": sum(r["kernel"] == name for r in conv_rows),
                      "max_rel_err": max(r["max_rel_err"] for r in conv_rows
                                         if r["kernel"] == name)}
               for name in ("grouped_conv_fwd", "grouped_conv_dx",
                            "grouped_conv_dw")}
    summary["fused_adamw"] = {
        "shapes": len(adamw_rows),
        "max_abs_err": max(r["max_abs_err"] for r in adamw_rows)}
    seconds = time.perf_counter() - t0
    print(f"[dist] kernels at this phase's shapes: {summary}, {seconds:.1f} "
          f"s", flush=True)
    return {"geometries": geoms, "conv": conv_rows, "adamw": adamw_rows,
            "summary": summary, "seconds": seconds}


def _weights(tree) -> dict:
    """The generator's and the discriminator's state (parameters and
    spectral buffers) of a state tree, flattened to host arrays."""
    from ste_gan_torch.parallel.multiprocess import flatten_state

    return flatten_state({"generator": tree["generator"],
                          "discriminator": tree["discriminator"]})


def _weight_deviation(got, want, init) -> float:
    """||got - want|| / ||want - init|| over the weights: how far two runs'
    weights part, as a share of how far the steps moved them."""
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum((want[k].astype(np.float64) - init[k]) ** 2))
              for k in want)
    return (num / den) ** 0.5


def _rank_weights(out: Path, world: int) -> list:
    """The weights each rank of a worker run saved."""
    keep = ("generator/", "discriminator/")
    return [{k: v for k, v in np.load(out / f"state_p{r}.npz").items()
             if k.startswith(keep)} for r in range(world)]


def _steady_ms(hist) -> float:
    """Median ms of the steps after the first (the first warms up)."""
    ms = sorted(h["ms"] for h in hist[1:])
    return ms[len(ms) // 2]


def _logged_launches(log_txt: Path) -> dict:
    """The hand-kernel launches a CLI's rank 0 logged at its end."""
    for line in reversed(log_txt.read_text().splitlines()):
        if "Hand-kernel launches in this process:" in line:
            return json.loads(line.split("process:", 1)[1])
    raise SystemExit(f"{log_txt} logged no kernel launches")


def check_dist(torch, card, counters, trainer_run):
    """``[dist]``: the data-parallel family on the one card.

    1. World 1 over NCCL at full width (``Config()``, 32 x 2048, bf16): the
       bare step from one state, then ``BARE_RERUNS`` times again (the
       yardstick: the largest loss gap of a rerun), then the DP and FSDP
       wrappers from the same state, 4 steps each; their losses within
       ``WORLD1_YARD_FACTOR`` x the yardstick; ms/step; persistent state bytes per
       rank, replicated and FSDP, and the FSDP rule's at 2, 4 and 8 ranks.
       Then every hand kernel against its plain version at the shapes of
       this phase (``check_dist_kernels``).
    2. Two ranks sharing the card over gloo at full width (16 rows each),
       through the worker CLI: DP, then FSDP; losses against world 1 within
       ``DIST_LOSS_RTOL``; ms/step per rank, collective ms per step,
       kernel launches per rank. Where gloo refuses CUDA tensors for
       ``all_gather_into_tensor`` / ``reduce_scatter_tensor``, one line
       says so and FSDP is not run. Each run's weights within
       ``DIST_WEIGHT_RTOL`` of world 1's and equal on both ranks; a control
       run of the worker without the gradient all-reduce must fail the
       weight gate.
    3. NCCL at 2 ranks, with two cards only.
    4. Fleet recovery (launcher, two gloo ranks, ``--tiny``, deterministic,
       6 steps, a recovery point every 2), beside 5: rank 1 killed before
       step 3 and the fleet recovered elastically on one rank from step 2; its
       final state against that step-2 point (what an uninterrupted run
       writes there) continued by one rank in this process with the
       worker's deterministic settings (rtol 2e-5, atol 2e-6). The
       recovery at an unchanged rank count is held on the CPU
       (``tests/test_torch_launch.py``).
    5. The trainer CLIs at 2 gloo ranks: ``train_gan`` for 6 steps on the
       [trainer] corpus, its last checkpoint resumed by the single-device
       trainer; ``train.encoder`` for 1 voiced epoch.
    6. ``EMGSynthesizer(devices=[cuda:0, cuda:0])`` at full width, 16 x 64
       frames, against one device (TF32 off, ``INFER_TOL``), with times.

    Two ranks on one card share its SMs and memory bandwidth: these runs
    measure correctness and the collectives' cost, not scaling."""
    import logging
    import os

    import torch.distributed as dist
    import yaml

    from ste_gan_torch.config import Config
    from ste_gan_torch.infer import EMGSynthesizer
    from ste_gan_torch.models.generator import init_emg_generator
    from ste_gan_torch.ops import fused_adamw as fa
    from ste_gan_torch.ops import grouped_conv as gc
    from ste_gan_torch.parallel import mesh
    from ste_gan_torch.parallel.fsdp import fsdp_sharding_summary
    from ste_gan_torch.parallel.launch import (
        FleetLauncher, free_port, parse_args, run_ranks)
    from ste_gan_torch.parallel.multiprocess import (
        deterministic, flatten_state, full_setup, run_steps, tiny_setup)
    from ste_gan_torch.train import train_gan
    from ste_gan_torch.train.checkpoint import host_copy
    from ste_gan_torch.train.gan import init_state, state_tree

    work = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "cards": torch.cuda.device_count()}
    print(f"[dist] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s) ({card})", flush=True)

    # ---- 1. World 1 over NCCL, full width. ----
    _, _, group = mesh.init_distributed(
        "nccl", 300, "cuda", f"tcp://localhost:{free_port()}")
    try:
        cfg, models = full_setup("cuda", seed=0)
        init = work / "init.pt"
        tree = state_tree(models, init_state(cfg, models))
        torch.save(host_copy(tree), init)
        weights = {"init": _weights(tree)}
        runs = {}
        for name in ("bare", *(f"bare_{i}" for i in range(1, BARE_RERUNS + 1))):
            tree, runs[name], _ = run_steps(cfg, models, DIST_STEPS,
                                            restore_ckpt=init)
            weights[name] = _weights(tree)
        for fn in counters.values():
            fn.launches = 0
        tree, runs["dp"], _ = run_steps(cfg, models, DIST_STEPS,
                                        restore_ckpt=init, group=group)
        weights["dp"] = _weights(tree)
        del tree
        _, runs["fsdp"], fsdp_stats = run_steps(
            cfg, models, DIST_STEPS, restore_ckpt=init, group=group,
            fsdp=True)
        world1_launches = {n: fn.launches for n, fn in counters.items()}
        summary = {n: fsdp_sharding_summary(models, ema=True, size=n)
                   for n in (1, 2, 4, 8)}
        report["kernels_at_dist_shapes"] = check_dist_kernels(
            torch, gc, fa, (cfg, models))
        del models
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    reruns = [f"bare_{i}" for i in range(1, BARE_RERUNS + 1)]
    rerun_gaps = [_loss_gap(runs[r], runs["bare"]) for r in reruns]
    yard = max(rerun_gaps)
    gaps = {w: _loss_gap(runs[w], runs["bare"]) for w in ("dp", "fsdp")}
    weight_dev = {w: _weight_deviation(weights[w], weights["bare"],
                                       weights["init"])
                  for w in (*reruns, "dp")}
    for r in ("bare", *reruns):
        del weights[r]
    ms = {name: _steady_ms(h) for name, h in runs.items()}
    report["world1"] = {"ms_per_step": ms, "yardstick_rel": yard,
                        "rerun_gaps": rerun_gaps,
                        "rel_gap": gaps, "losses": runs,
                        "weight_deviation_from_bare": weight_dev,
                        "launches": world1_launches,
                        "fsdp_persistent_bytes": fsdp_stats[
                            "persistent_bytes"],
                        "fsdp_rule": summary}
    bare_ms = " / ".join(f"{ms[r]:.2f}" for r in ("bare", *reruns))
    print(f"[dist] world 1 over NCCL, full width, {DIST_STEPS} steps: "
          f"ms/step bare {bare_ms}, DP wrapper {ms['dp']:.2f}, FSDP wrapper "
          f"{ms['fsdp']:.2f}; largest relative loss gap to the bare step: "
          f"DP {gaps['dp']:.3e}, FSDP {gaps['fsdp']:.3e}, its reruns "
          f"{', '.join(f'{g:.3e}' for g in rerun_gaps)}; weight deviation "
          f"from the bare step: its reruns "
          f"{', '.join(f'{weight_dev[r]:.3e}' for r in reruns)}, DP "
          f"{weight_dev['dp']:.3e} ({card})", flush=True)
    print(f"[dist] persistent train state per rank: replicated "
          f"{summary[1]['replicated_bytes'] / 2**20:.1f} MB, FSDP at 1 rank "
          f"held {fsdp_stats['persistent_bytes'] / 2**20:.1f} MB; the FSDP "
          f"rule at 2 / 4 / 8 ranks: "
          + " / ".join(f"{summary[n]['per_rank_bytes'] / 2**20:.1f} MB"
                       for n in (2, 4, 8)), flush=True)
    for w, gap in gaps.items():
        if not gap <= WORLD1_YARD_FACTOR * yard:
            raise SystemExit(f"[dist] the {w} wrapper at world 1 moved the "
                             f"losses by {gap:.3e}, beyond "
                             f"{WORLD1_YARD_FACTOR:g}x the bare step's own "
                             f"{yard:.3e}")

    # ---- 2. Two ranks sharing the card over gloo, full width. ----
    # Each run against world 1: its losses within DIST_LOSS_RTOL, its
    # weights within DIST_WEIGHT_RTOL of the world-1 DP run's, its two
    # ranks' weights equal bit for bit. The control (the gradient
    # all-reduce left out) must fail the weight gate.
    two = {}
    for mode, more in (("dp", ()), ("fsdp", ("--fsdp",)),
                       ("control_no_allreduce", ())):
        out = work / f"gloo_{mode}"
        try:
            hist, stats = _dist_worker(
                out, 2, "--full", "--dist_backend", "gloo", "--steps",
                str(DIST_STEPS), *more, no_allreduce=mode.startswith(
                    "control"))
        except RuntimeError as err:
            text = str(err)
            if mode != "fsdp" or "gloo" not in text.lower() or not any(
                    k in text for k in ("not supported", "unsupported",
                                        "NotImplemented", "does not support")):
                raise
            print(f"[dist] gloo does not take CUDA tensors for "
                  f"all_gather_into_tensor / reduce_scatter_tensor: "
                  f"{text.splitlines()[-1]}; FSDP at 2 ranks waits for NCCL "
                  f"(two cards)", flush=True)
            two[mode] = {"unsupported": text[-2000:]}
            continue
        rank_w = _rank_weights(out, 2)
        shutil.rmtree(out)
        gaps = _loss_gaps(hist[0], runs["bare"])
        two[mode] = {
            "gap": max(gaps), "gaps_per_step": gaps,
            "weight_deviation": _weight_deviation(
                rank_w[0], weights["dp"], weights["init"]),
            "replicas_equal": all(np.array_equal(rank_w[0][k], rank_w[1][k])
                                  for k in rank_w[0]),
            "ms": [_steady_ms(h) for h in hist],
            "comm_ms_per_step": [s["comm_ms_per_step"] for s in stats],
            "launches": [s["launches"] for s in stats]}
        if mode == "fsdp":
            two[mode]["persistent_bytes"] = [s["persistent_bytes"]
                                             for s in stats]
        del rank_w
    report["two_ranks_gloo"] = two
    for mode, r in two.items():
        if "gap" not in r:
            continue
        print(f"[dist] 2 ranks on one card over gloo, {mode}, full width "
              f"(16 rows each): ms/step per rank "
              f"{', '.join(f'{x:.2f}' for x in r['ms'])}; collectives "
              f"{', '.join(f'{x:.2f}' for x in r['comm_ms_per_step'])} ms "
              f"per step (141.6 MB of f32 gradients through the host); "
              f"relative loss gap to world 1 per step "
              f"{', '.join(f'{g:.3e}' for g in r['gaps_per_step'])} (tol "
              f"{DIST_LOSS_RTOL:g}); weight deviation from world 1 "
              f"{r['weight_deviation']:.3e} (tol {DIST_WEIGHT_RTOL:g}); "
              f"ranks' weights equal {r['replicas_equal']}; launches per "
              f"rank {r['launches']}"
              + (f"; state held per rank "
                 f"{[round(b / 2**20, 1) for b in r['persistent_bytes']]} MB"
                 if "persistent_bytes" in r else "")
              + f" — two ranks share one card: correctness and collective "
              f"cost, not scaling ({card})", flush=True)
        if mode.startswith("control"):
            print(f"[dist] the control is caught by the loss gate "
                  f"{r['gap'] > DIST_LOSS_RTOL}, by the weight gate "
                  f"{r['weight_deviation'] > DIST_WEIGHT_RTOL}, by the "
                  f"ranks' equality {not r['replicas_equal']}", flush=True)
            if not r["weight_deviation"] > DIST_WEIGHT_RTOL:
                raise SystemExit(f"[dist] the weight gate "
                                 f"({DIST_WEIGHT_RTOL:g}) does not catch "
                                 f"ranks that skip the gradient all-reduce: "
                                 f"{r['weight_deviation']:.3e}")
            continue
        if not (r["gap"] <= DIST_LOSS_RTOL
                and r["weight_deviation"] <= DIST_WEIGHT_RTOL
                and r["replicas_equal"]):
            raise SystemExit(f"[dist] 2 ranks ({mode}) left world 1: loss "
                             f"gap {r['gap']:.3e}, weight deviation "
                             f"{r['weight_deviation']:.3e}, ranks' weights "
                             f"equal {r['replicas_equal']}")
        missing = [k for rank in r["launches"] for k in counters
                   if rank[k] <= 0]
        if missing:
            raise SystemExit(f"[dist] kernels never launched on a rank: "
                             f"{missing}")

    # ---- 3. NCCL at 2 ranks: two cards only. ----
    if torch.cuda.device_count() >= 2:
        hist_n, stats_n = _dist_worker(work / "nccl_dp", 2, "--full",
                                       "--steps", str(DIST_STEPS),
                                       "--no-save_state")
        report["two_ranks_nccl"] = {
            "gap": _loss_gap(hist_n[0], runs["bare"]),
            "ms": [_steady_ms(h) for h in hist_n],
            "comm_ms_per_step": [s["comm_ms_per_step"] for s in stats_n]}
        print(f"[dist] 2 ranks over NCCL on 2 cards: "
              f"{report['two_ranks_nccl']} ({card})", flush=True)
    else:
        report["two_ranks_nccl"] = None
        print("[dist] NCCL at 2 ranks waits for a machine with two cards",
              flush=True)

    # ---- 4. Fleet recovery on the card: a crash of rank 1 before step 3
    # recovered elastically on one rank; the fleet runs beside 5 (its
    # attempts are mostly process start-ups; 5 reports seconds only), and
    # its check, which sets this process's deterministic settings, after
    # 5. ----
    base = ["--num_processes", "2", "--steps", "6", "--ckpt_every", "2",
            "--device", "cuda", "--dist_backend", "gloo", "--timeout_s",
            "300", "--attempt_timeout", "600", "--deterministic"]
    t_fleet = time.perf_counter()
    run_dir = work / "fleet_elastic"
    fleet_out = {}

    def run_fleet():
        try:
            fleet_out["summary"] = FleetLauncher(
                parse_args(base + ["--run_dir", str(run_dir), "--elastic"]),
                env={"STE_MP_CRASH": f"3:1:{run_dir / 'crash.flag'}"}).run()
        except BaseException as err:  # reported, and fatal, below
            fleet_out["error"] = err
        fleet_out["seconds"] = time.perf_counter() - t_fleet

    fleet_thread = threading.Thread(target=run_fleet)
    fleet_thread.start()

    try:
        # ---- 5. The trainer CLIs at world 2 (gloo, one card). ----
        trainer_work = ROOT / "build" / "chip_smoke_trainer"
        with open(ROOT / "configs" / "ste_gan_base_gantts.yaml") as fp:
            base_cfg = yaml.safe_load(fp)
        base_cfg["train"].update(interval_log=1, interval_valid=3,
                                 interval_save=3, save_last_epoch_interval=1,
                                 interval_sample=10_000)
        paths = {}
        for name in ("two", "resume"):
            base_cfg["model_base_dir"] = str(work / f"gan_{name}")
            paths[name] = work / f"gan_{name}.yaml"
            paths[name].write_text(yaml.safe_dump(base_cfg))

        def gan_argv(name, max_steps, *more):
            return ["--config", str(paths[name]), "--data",
                    str(trainer_work / "data.yaml"), "--emg_enc_cfg",
                    str(ROOT / "configs" / "emg_encoder" /
                        "conv_transformer.yaml"),
                    "--max_steps", str(max_steps), *more]

        t0 = time.perf_counter()
        run_ranks([sys.executable, "-m", "ste_gan_torch.train.train_gan",
                   *gan_argv("two", 5, "--dist_backend", "gloo",
                             "--dist_timeout_s", "300")],
                  2, work / "gan_two_logs", 900, env=_dist_env())
        gan_s = time.perf_counter() - t0
        run_name = Path(trainer_run).name
        gan_run = work / "gan_two" / run_name
        for entry in (".done", "checkpoint-final", "checkpoint-00000003",
                      "best", "metrics.jsonl"):
            if not (gan_run / entry).exists():
                raise SystemExit(f"[dist] 2-rank trainer run lacks {entry}")
        logged = [json.loads(line) for line in
                  (gan_run / "metrics.jsonl").read_text().splitlines()]
        g_losses = {r["step"]: r["value"] for r in logged
                    if r["tag"] == "train_loss/generator"}
        gan_launches = _logged_launches(gan_run / "log.txt")
        messages = []

        class Capture(logging.Handler):
            def emit(self, record):
                messages.append(record.getMessage())

        capture = Capture()
        logging.getLogger().addHandler(capture)
        try:
            t0 = time.perf_counter()
            train_gan.main(train_gan.parse_args(gan_argv(
                "resume", 7, "--checkpoint",
                str(gan_run / "checkpoint-final"))))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        finally:
            logging.getLogger().removeHandler(capture)
        resumed = [m for m in messages if m.startswith("Restored train state")]
        resume_run = work / "gan_resume" / run_name
        r_losses = {json.loads(line)["step"]: json.loads(line)["value"]
                    for line in (resume_run / "metrics.jsonl").read_text()
                    .splitlines()
                    if json.loads(line)["tag"] == "train_loss/generator"}
        values = list(g_losses.values()) + list(r_losses.values())
        if (sorted(g_losses) != list(range(6)) or sorted(r_losses) != [6, 7]
                or not resumed or "at step 6 " not in resumed[0]
                or any(v != v or abs(v) == float("inf") for v in values)):
            raise SystemExit(f"[dist] the 2-rank trainer or its single-device "
                             f"resume went wrong: {g_losses}, {r_losses}, "
                             f"{resumed}")
        missing = [k for k in counters if gan_launches[k] <= 0]
        if missing:
            raise SystemExit(f"[dist] the 2-rank trainer's rank 0 never "
                             f"launched {missing}")

        enc_data = ROOT / "build" / "chip_smoke_encoder" / "synthetic.yaml"
        t0 = time.perf_counter()
        run_ranks([sys.executable, "-m", "ste_gan_torch.train.encoder",
                   "--config",
                   str(ROOT / "configs" / "ste_gan_base_gantts.yaml"),
                   "--data", str(enc_data), "--emg_enc_cfg",
                   str(ROOT / "configs" / "emg_encoder" /
                       "conv_transformer.yaml"),
                   "--exp_dir", str(work / "enc_two"), "--num_epochs", "1",
                   "--dist_backend", "gloo", "--dist_timeout_s", "300"],
                  2, work / "enc_two_logs", 900, env=_dist_env())
        enc_s = time.perf_counter() - t0
        enc_run = next((work / "enc_two").iterdir())
        enc_logged = [json.loads(line) for line in
                      (enc_run / "metrics.jsonl").read_text().splitlines()]
        enc_losses = [r["value"] for r in enc_logged
                      if r["tag"] in ("train/loss", "val/loss")]
        enc_launches = _logged_launches(enc_run / "log.txt")
        if (not (enc_run / ".done").exists() or not enc_losses
                or any(v != v or abs(v) == float("inf") for v in enc_losses)
                or enc_launches["fused_adamw"] <= 0):
            raise SystemExit(f"[dist] the 2-rank encoder trainer went wrong: "
                             f"{enc_losses}, {enc_launches}")
        report["trainers"] = {
            "gan_two_ranks_s": gan_s, "gan_losses": g_losses,
            "gan_rank0_launches": gan_launches, "resume_s": resume_s,
            "resumed_losses": r_losses, "encoder_two_ranks_s": enc_s,
            "encoder_losses": enc_losses,
            "encoder_rank0_launches": enc_launches}
        print(f"[dist] train_gan at 2 gloo ranks: steps 0-5 in {gan_s:.1f} s "
              f"(G "
              f"{', '.join(f'{g_losses[s]:.3f}' for s in sorted(g_losses))}), "
              f"rank 0 launches {gan_launches}; resumed by the single-device "
              f"trainer at step 6 to 7 in {resume_s:.1f} s; train.encoder at "
              f"2 "
              f"gloo ranks, 1 voiced epoch in {enc_s:.1f} s, rank 0 launches "
              f"{enc_launches} ({card})", flush=True)
    finally:
        # A failed trainer run still waits for the fleet's ranks to end.
        fleet_thread.join()

    if "error" in fleet_out:
        raise SystemExit(f"[dist] the fleet failed: {fleet_out['error']!r}")
    fleet = fleet_out["summary"]
    # The elastic run's schedule without the crash: its two ranks' step-2
    # recovery point (what an uninterrupted two-rank run writes there, bit
    # for bit: --deterministic) continued by one rank, here, with the
    # worker's --deterministic settings (a rank of one sums nothing: the
    # same arithmetic as no group).
    saved = (dict(os.environ), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    deterministic()
    try:
        cfg_t, models_t = tiny_setup("cuda")
        tree, _, _ = run_steps(cfg_t, models_t, 4, start_step=2,
                               restore_ckpt=run_dir / "recovery" /
                               "step_2.pt")
        want = flatten_state(tree)
        del models_t, tree
    finally:
        os.environ.clear()
        os.environ.update(saved[0])
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[1:5]
        torch.use_deterministic_algorithms(saved[5])
    fleet_s = fleet_out["seconds"]
    got = dict(np.load(Path(fleet["final_out"]) / "state_p0.npz"))
    if set(got) != set(want):
        raise SystemExit("[dist] fleet: the elastic run's state keys differ")
    worst = max(float(np.max(np.abs(got[k] - want[k])
                             / (2e-6 + 2e-5 * np.abs(want[k]))))
                for k in want)
    report["fleet"] = {"summary": fleet, "seconds": fleet_s,
                       "worst_over_tolerance": worst}
    print(f"[dist] fleet on the card (2 gloo ranks, tiny, deterministic, "
          f"6 steps, a recovery point every 2): rank 1 killed before step 3, "
          f"recovered from {fleet['recovered_from']} on world sizes "
          f"{fleet['world_sizes']}; final state against its step-2 point "
          f"continued on one rank at {worst:.3f} of rtol 2e-5 / atol 2e-6; "
          f"attempts {fleet['attempt_s']} s, {fleet_s:.1f} s in all "
          f"({card})", flush=True)
    if (fleet["recovered_from"] != [2] or fleet["world_sizes"] != [2, 1]
            or not worst <= 1.0):
        raise SystemExit(f"[dist] fleet recovery failed: {report['fleet']}")

    # ---- 6. Scale-out synthesis: one card named twice. ----
    torch.backends.cudnn.allow_tf32 = False
    cfg_s = Config()
    sd = init_emg_generator(cfg_s, torch.float32,
                            torch.Generator().manual_seed(0)).state_dict()
    one = EMGSynthesizer.from_config(cfg_s, sd, bucket=64, device="cuda")
    twice = EMGSynthesizer.from_config(cfg_s, sd, bucket=64,
                                       devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(12)
    feats = torch.from_numpy(rng.normal(size=(16, 64, 256)).astype(
        np.float32)).cuda()
    sess = torch.from_numpy(rng.integers(0, cfg_s.data.num_emg_sessions,
                                         16)).cuda()
    want = one.synthesize_batch(feats, sess)
    got = twice.synthesize_batch(feats, sess)
    rel = float((got - want).abs().max() / want.abs().max())
    ms_one = cuda_time(lambda: one.synthesize_batch(feats, sess))
    ms_two = cuda_time(lambda: twice.synthesize_batch(feats, sess))
    report["synthesis"] = {"rel": rel, "ms_one": ms_one, "ms_two": ms_two}
    print(f"[dist] EMGSynthesizer(devices=[cuda:0, cuda:0]) at full width, "
          f"16 x 64 frames: within {rel:.3e} of one device (tol "
          f"{INFER_TOL:g}, TF32 off); {ms_two:.3f} ms per call against "
          f"{ms_one:.3f} ms on one device (two replicas share one card) "
          f"({card})", flush=True)
    if not rel <= INFER_TOL:
        raise SystemExit("[dist] the two-replica synthesizer differs")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"[dist] phase took {report['seconds']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    world1 = {"bare": runs["bare"], "init": weights["init"],
              "dp": weights["dp"],
              "state_bytes": summary[1]["replicated_bytes"]}
    return report, world1


#: The worker with ``copy_to_model``'s backward sum left out: each model
#: rank keeps only its slab's part of every input gradient. The control
#: that shows the ``[tp]`` gates catch a missing sum.
NO_COPY_SUM_WORKER = (
    "import sys\n"
    "from ste_gan_torch.parallel import tensor_parallel as tp\n"
    "tp._CopyToModel.backward = staticmethod(\n"
    "    lambda ctx, grad: (grad, None, None))\n"
    "from ste_gan_torch.parallel.multiprocess import main\n"
    "main(sys.argv[1:])\n")


def _split_slabs(module, model: int):
    """``module``, in place, as ``tensor_parallel.shard_module_`` leaves
    model rank ``model - 1`` of ``model`` (no group: only the shapes are
    read)."""
    from ste_gan_torch.parallel import tensor_parallel as tp

    tp.shard_module_(module, tp.Mesh2D(None, None, None, 0, 1, model - 1,
                                       model))
    return module


def check_tp_kernels(torch, gc, fa, full):
    """The hand kernels against their plain versions at the per-rank shapes
    that tensor parallelism runs, each fatal on a disagreement. Forward, dX
    and dW (f32 and bf16 at ``TOL``) at every grouped layer of: the small
    (shipped) and the full discriminators at 2 and 4 model ranks on paired
    2B = 64 rows; the tiny discriminator of [tp]'s tiny layouts at 2 model
    ranks on 16 and 32 paired rows ((2, 2) and (1, 2) ``--fsdp``). AdamW
    (1e-6) over the slabs of the shipped G and D at 2 and 4, of the tiny G
    and D at 2 ((2, 2)), over one flat tensor the size of each tiny
    network's (1, 2) hybrid-FSDP shard, and over the encoder's slabs at 2
    (``train.encoder --model_parallel 2``). Every shape is read from
    modules that ``shard_module_`` split, so the shapes held are those that
    run. These launches are not counted."""
    from ste_gan_torch.config import load_config
    from ste_gan_torch.models.discriminator import DiscriminatorEnsemble
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.parallel.fsdp import shard_numel
    from ste_gan_torch.parallel.multiprocess import tiny_setup
    from ste_gan_torch.train.gan import build_models

    t0 = time.perf_counter()
    cfg, _ = full
    cfg_t, tiny = tiny_setup("cpu")
    gen = torch.Generator(device="cuda").manual_seed(10)
    geoms, dense, slabs = {}, {}, {}

    def hold(label, disc, c, row_counts):
        per_rank = [g for rows in row_counts for g in scale_disc_geometries(
            gc, disc, c.train.chunk_size, rows, c.data.num_emg_channels)]
        geoms[label] = [g for g in per_rank if g[-1] > 1]
        dense[label] = [g for g in per_rank if g[-1] == 1]

    def leaves(label, net):
        slabs[label] = [p.shape for p in net.parameters()]

    for model in (2, 4):
        sliced = build_models(cfg, seed=0, device="cpu")
        for net in ("generator", "discriminator"):
            leaves(f"{net}_model{model}",
                   _split_slabs(getattr(sliced, net), model))
        hold(f"small_model{model}", sliced.discriminator, cfg,
             (2 * cfg.train.batch_size,))
        hold(f"full_model{model}",
             _split_slabs(DiscriminatorEnsemble(small=False), model), cfg,
             (2 * cfg.train.batch_size,))
        del sliced
    for net in ("generator", "discriminator"):
        leaves(f"tiny_{net}_model2", _split_slabs(getattr(tiny, net), 2))
    hold("tiny_model2", tiny.discriminator, cfg_t,
         (cfg_t.train.batch_size, 2 * cfg_t.train.batch_size))
    cfg_e = load_config(
        str(ROOT / "configs" / "ste_gan_base_gantts.yaml"),
        str(ROOT / "configs" / "data" / "synthetic.yaml"),
        str(ROOT / "configs" / "emg_encoder" / "conv_transformer.yaml"))
    leaves("encoder_model2",
           _split_slabs(init_emg_encoder(cfg_e, torch.float32), 2))

    conv_rows = [row for label, gs in geoms.items()
                 for row in hold_conv(torch, gc, gs, gen, f"tp-{label}")]
    gan_hyper = dict(lr=2e-4, b1=0.8, b2=0.99, weight_decay=1e-2)
    enc_hyper = dict(lr=3e-4, b1=0.9, b2=0.999, weight_decay=1e-5)
    adamw_rows = []
    for label, shapes in slabs.items():
        hyper = enc_hyper if label.startswith("encoder") else gan_hyper
        adamw_rows.append({"network": label, "layout": "slabs",
                           **adamw_row(torch, fa, shapes, gen, **hyper)})
        if label.startswith("tiny_"):
            n = shard_numel([int(np.prod(s)) for s in shapes], 1)
            adamw_rows.append({"network": label, "layout": "fsdp_1x2_shard",
                               **adamw_row(torch, fa, [(n,)], gen,
                                           **gan_hyper)})
    for row in adamw_rows:
        print(f"[tp] fused_adamw {row['network']} {row['layout']} "
              f"({row['params']} params, {row['leaves']} leaves): max|err| "
              f"{row['max_abs_err']:.3e} (tol {row['tol']:g}) kernel "
              f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library "
              f"{row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms",
              flush=True)
    summary = {name: {"shapes": sum(r["kernel"] == name for r in conv_rows),
                      "max_rel_err": max(r["max_rel_err"] for r in conv_rows
                                         if r["kernel"] == name)}
               for name in ("grouped_conv_fwd", "grouped_conv_dx",
                            "grouped_conv_dw")}
    summary["fused_adamw"] = {
        "shapes": len(adamw_rows),
        "max_abs_err": max(r["max_abs_err"] for r in adamw_rows)}
    seconds = time.perf_counter() - t0
    print(f"[tp] kernels at the per-rank shapes: {summary}; grouped layers "
          f"per rank {({k: len(v) for k, v in geoms.items()})}, fallen to one "
          f"group (F.conv1d) {({k: len(v) for k, v in dense.items()})}, "
          f"{seconds:.1f} s", flush=True)
    return {"geometries": geoms, "dense_geometries": dense,
            "conv": conv_rows, "adamw": adamw_rows, "summary": summary,
            "seconds": seconds}


def _tiny_world1(torch, steps: int):
    """The tiny setup's ``steps`` from its seed on this card, one rank,
    with the worker's ``--deterministic`` settings: (history, weights)."""
    from ste_gan_torch.parallel.multiprocess import (
        deterministic, run_steps, tiny_setup)

    saved = (dict(os.environ), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    deterministic()
    try:
        cfg_t, models_t = tiny_setup("cuda")
        tree, hist, _ = run_steps(cfg_t, models_t, steps)
        return hist, _weights(tree)
    finally:
        os.environ.clear()
        os.environ.update(saved[0])
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[1:5]
        torch.use_deterministic_algorithms(saved[5])


def check_tp(torch, card, counters, world1, world1_encoder, trainer_run):
    """``[tp]``: tensor parallelism on the one card, gloo ranks sharing it.

    1. ``(data, model) = (1, 2)`` at the bare step's full width
       (``Config()``, 32 x 2048, bf16) through the worker, ``DIST_STEPS``
       steps: losses within ``DIST_LOSS_RTOL`` of [dist]'s world 1, weights
       within ``DIST_WEIGHT_RTOL`` (``_weight_deviation`` against world 1's
       DP run), both ranks' gathered states equal, every GAN kernel
       launched on each rank; ms/step, collectives and state bytes per
       rank. Then a control run without ``copy_to_model``'s backward sum
       (``NO_COPY_SUM_WORKER``), which must fail a gate.
    2. The tiny setup (``--deterministic``) at (1, 2) with ``--fsdp`` and
       at (2, 2), beside the control: losses and weights against the tiny
       world 1 on this card, ranks equal.
    3. One voiced epoch of ``train.encoder --model_parallel 2``, beside
       the trainer runs of 4: its train and validation losses within
       ``DIST_LOSS_RTOL`` of the first epoch of [encoder-trainer]'s world-1
       voiced run (``world1_encoder``).
    4. ``train_gan`` on the [trainer] corpus: world 1 for steps 0-1, its
       checkpoint resumed at (1, 2) for steps 2-3, that one resumed at
       world 1 for steps 4-5; the G and D losses within ``DIST_LOSS_RTOL``
       of the same six steps run uninterrupted at world 1.

    Two ranks on one card share its SMs and the host: correctness and the
    collectives' cost, not scaling."""
    import logging

    import yaml

    from ste_gan_torch.parallel.launch import run_ranks
    from ste_gan_torch.train import train_gan

    work = ROOT / "build" / "chip_smoke_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    report = {}

    def gates(hist, stats, rank_w, want_hist, want_w, init_w):
        gaps = _loss_gaps(hist[0], want_hist)
        return {
            "gap": max(gaps), "gaps_per_step": gaps,
            "weight_deviation": _weight_deviation(rank_w[0], want_w, init_w),
            "replicas_equal": all(np.array_equal(rank_w[0][k], w[k])
                                  for w in rank_w[1:] for k in rank_w[0]),
            "ms": [_steady_ms(h) for h in hist],
            "tp_comm_ms_per_step": [s["tp_comm_ms_per_step"] for s in stats],
            "dp_comm_ms_per_step": [s["comm_ms_per_step"] for s in stats],
            "tp_calls_per_step": stats[0]["tp_calls_per_step"],
            "tp_mb_per_step": stats[0]["tp_mb_per_step"],
            "persistent_bytes": [s["persistent_bytes"] for s in stats],
            "launches": [s["launches"] for s in stats]}

    def sound(name, r):
        return (r["gap"] <= DIST_LOSS_RTOL
                and r["weight_deviation"] <= DIST_WEIGHT_RTOL
                and r["replicas_equal"])

    # ---- 1. (1, 2) at full width, alone on the card (timed). ----
    out = work / "full_1x2"
    hist, stats = _dist_worker(out, 2, "--full", "--dist_backend", "gloo",
                               "--steps", str(DIST_STEPS),
                               "--model_parallel", "2")
    full = gates(hist, stats, _rank_weights(out, 2), world1["bare"],
                 world1["dp"], world1["init"])
    shutil.rmtree(out)
    report["full_1x2"] = full
    print(f"[tp] (data, model) = (1, 2) on one card over gloo, full width "
          f"(32 rows on each model rank): ms/step per rank "
          f"{', '.join(f'{x:.2f}' for x in full['ms'])}; tensor-parallel "
          f"collectives {full['tp_calls_per_step']:.0f} per step, "
          f"{full['tp_mb_per_step']:.1f} MB, "
          f"{', '.join(f'{x:.2f}' for x in full['tp_comm_ms_per_step'])} ms "
          f"per step; state held per rank "
          f"{[round(b / 2**20, 1) for b in full['persistent_bytes']]} MB "
          f"(world 1: {world1['state_bytes'] / 2**20:.1f}); relative loss "
          f"gap to world 1 per step "
          f"{', '.join(f'{g:.3e}' for g in full['gaps_per_step'])} (tol "
          f"{DIST_LOSS_RTOL:g}); weight deviation "
          f"{full['weight_deviation']:.3e} (tol {DIST_WEIGHT_RTOL:g}); "
          f"ranks' states equal "
          f"{full['replicas_equal']}; launches per rank {full['launches']} "
          f"— two ranks share one card: correctness and collective cost, not "
          f"scaling ({card})", flush=True)
    if not sound("full_1x2", full):
        raise SystemExit(f"[tp] (1, 2) left world 1: {full}")
    missing = [k for rank in full["launches"] for k in counters
               if rank[k] <= 0]
    if missing:
        raise SystemExit(f"[tp] kernels never launched on a rank: {missing}")

    # ---- 2. The control and the tiny layouts, side by side. ----
    t0 = time.perf_counter()
    tiny_hist, tiny_w = _tiny_world1(torch, DIST_STEPS)
    runs, errors = {}, {}

    def launch(name, world, *flags, control=False):
        out = work / name
        try:
            runs[name] = _dist_worker(
                out, world, *flags,
                code=NO_COPY_SUM_WORKER if control else "") + (
                    _rank_weights(out, world),)
        except Exception as err:  # reported, and fatal, below
            errors[name] = err

    threads = [
        threading.Thread(target=launch, args=(
            "control_no_copy_sum", 2, "--full", "--dist_backend", "gloo",
            "--steps", str(DIST_STEPS), "--model_parallel", "2"),
            kwargs={"control": True}),
        threading.Thread(target=launch, args=(
            "tiny_1x2_fsdp", 2, "--tiny", "--deterministic", "--dist_backend",
            "gloo", "--steps", str(DIST_STEPS), "--model_parallel", "2",
            "--fsdp")),
        threading.Thread(target=launch, args=(
            "tiny_2x2", 4, "--tiny", "--deterministic", "--dist_backend",
            "gloo", "--steps", str(DIST_STEPS), "--model_parallel", "2"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise SystemExit(f"[tp] runs failed: {errors}")
    hist, stats, rank_w = runs["control_no_copy_sum"]
    control = gates(hist, stats, rank_w, world1["bare"], world1["dp"],
                    world1["init"])
    report["control_no_copy_sum"] = control
    caught = {"loss": control["gap"] > DIST_LOSS_RTOL,
              "weights": control["weight_deviation"] > DIST_WEIGHT_RTOL,
              "ranks_equal": not control["replicas_equal"]}
    print(f"[tp] control without copy_to_model's backward sum, (1, 2) full "
          f"width: loss gap {control['gap']:.3e}, weight deviation "
          f"{control['weight_deviation']:.3e}; caught by {caught} ({card})",
          flush=True)
    if not any(caught.values()):
        raise SystemExit("[tp] no gate catches ranks that skip "
                         "copy_to_model's backward sum")
    for name in ("tiny_1x2_fsdp", "tiny_2x2"):
        hist, stats, rank_w = runs[name]
        r = gates(hist, stats, rank_w, tiny_hist, tiny_w,
                  _weights_of_init(torch))
        report[name] = r
        print(f"[tp] {name} (tiny, deterministic): loss gap to world 1 "
              f"{r['gap']:.3e}, weight deviation {r['weight_deviation']:.3e}, "
              f"ranks' states equal {r['replicas_equal']}; state held per "
              f"rank {[round(b / 2**20, 3) for b in r['persistent_bytes']]} "
              f"MB; collectives {r['tp_calls_per_step']:.0f} per step "
              f"({card})", flush=True)
        if not sound(name, r):
            raise SystemExit(f"[tp] {name} left world 1: {r}")
    report["side_by_side_s"] = time.perf_counter() - t0

    # ---- 3. One voiced epoch of the encoder trainer at (1, 2), beside
    # the trainer runs of 4 (its seconds include sharing the card). ----
    enc_data = ROOT / "build" / "chip_smoke_encoder" / "synthetic.yaml"
    enc_result = {}

    def encoder_epoch():
        t0 = time.perf_counter()
        try:
            run_ranks([sys.executable, "-m", "ste_gan_torch.train.encoder",
                       "--config",
                       str(ROOT / "configs" / "ste_gan_base_gantts.yaml"),
                       "--data", str(enc_data), "--emg_enc_cfg",
                       str(ROOT / "configs" / "emg_encoder" /
                           "conv_transformer.yaml"),
                       "--exp_dir", str(work / "enc"), "--num_epochs", "1",
                       "--model_parallel", "2", "--dist_backend", "gloo",
                       "--dist_timeout_s", "300"],
                      2, work / "enc_logs", 900, env=_dist_env())
        except Exception as err:  # reported, and fatal, below
            enc_result["error"] = err
        enc_result["seconds"] = time.perf_counter() - t0

    enc_thread = threading.Thread(target=encoder_epoch)
    enc_thread.start()

    try:
        # ---- 4. train_gan: world 1 -> (1, 2) -> world 1. ----
        trainer_work = ROOT / "build" / "chip_smoke_trainer"
        with open(ROOT / "configs" / "ste_gan_base_gantts.yaml") as fp:
            base_cfg = yaml.safe_load(fp)
        base_cfg["train"].update(interval_log=1, interval_valid=2,
                                 interval_save=10_000,
                                 save_last_epoch_interval=1,
                                 interval_sample=10_000)
        paths = {}
        for name in ("a", "b", "c", "u"):
            base_cfg["model_base_dir"] = str(work / f"gan_{name}")
            paths[name] = work / f"gan_{name}.yaml"
            paths[name].write_text(yaml.safe_dump(base_cfg))

        def gan_argv(name, max_steps, *more):
            return ["--config", str(paths[name]), "--data",
                    str(trainer_work / "data.yaml"), "--emg_enc_cfg",
                    str(ROOT / "configs" / "emg_encoder" /
                        "conv_transformer.yaml"),
                    "--max_steps", str(max_steps), *more]

        run_name = Path(trainer_run).name

        def two_ranks(name, max_steps, *more):
            t0 = time.perf_counter()
            run_ranks([sys.executable, "-m", "ste_gan_torch.train.train_gan",
                       *gan_argv(name, max_steps, "--model_parallel", "2",
                                 "--dist_backend", "gloo", "--dist_timeout_s",
                                 "300", *more)],
                      2, work / f"gan_{name}_logs", 900, env=_dist_env())
            return work / f"gan_{name}" / run_name, time.perf_counter() - t0

        messages = []

        class Capture(logging.Handler):
            def emit(self, record):
                messages.append(record.getMessage())

        def one_rank(name, max_steps, *more):
            t0 = time.perf_counter()
            train_gan.main(train_gan.parse_args(gan_argv(name, max_steps,
                                                         *more)))
            torch.cuda.synchronize()
            return work / f"gan_{name}" / run_name, time.perf_counter() - t0

        capture = Capture()
        logging.getLogger().addHandler(capture)
        try:
            # World 1 for steps 0-1, its checkpoint at (1, 2) for 2-3, and
            # that one at world 1 again for 4-5.
            run_a, a_s = one_rank("a", 1)
            run_b, b_s = two_ranks("b", 3, "--checkpoint",
                                   str(run_a / "checkpoint-final"))
            run_c, c_s = one_rank("c", 5, "--checkpoint",
                                  str(run_b / "checkpoint-final"))
            # The same six steps uninterrupted at world 1: the yardstick.
            run_u, u_s = one_rank("u", 5)
        finally:
            logging.getLogger().removeHandler(capture)

        def losses(run, net="generator"):
            recs = [json.loads(line) for line in
                    (run / "metrics.jsonl").read_text().splitlines()]
            return {r["step"]: r["value"] for r in recs
                    if r["tag"] == f"train_loss/{net}"}

        la, lb, lc = losses(run_a), losses(run_b), losses(run_c)
        g_all = {**la, **lb, **lc}
        chain = [{"G": g_all[k], "D": d} for k, d in sorted({
            **losses(run_a, "discriminator"), **losses(run_b, "discriminator"),
            **losses(run_c, "discriminator")}.items())]
        lu, du = losses(run_u), losses(run_u, "discriminator")
        uninterrupted = [{"G": lu[k], "D": du[k]} for k in sorted(lu)]
        restored_b = [ln for ln in (run_b / "log.txt").read_text().splitlines()
                      if "Restored train state at step 2 " in ln]
        restored_c = [m for m in messages
                      if m.startswith("Restored train state at step 4 ")]
        launches_b = _logged_launches(run_b / "log.txt")
        values = [*la.values(), *lb.values(), *lc.values()]
        chain_gaps = (_loss_gaps(chain, uninterrupted)
                      if len(chain) == len(uninterrupted) == 6 else None)
        report["trainer"] = {"world1_0_1_s": a_s, "tp_2_3_s": b_s,
                             "world1_4_5_s": c_s, "uninterrupted_s": u_s,
                             "losses": chain,
                             "uninterrupted_losses": uninterrupted,
                             "gaps_per_step": chain_gaps,
                             "rank0_launches": launches_b}
        print(f"[tp] train_gan: world 1 for steps 0-1 in {a_s:.1f} s, its "
              f"checkpoint at (1, 2) for steps 2-3 in {b_s:.1f} s (two process "
              f"start-ups, a validation and the saves; rank 0 launches "
              f"{launches_b}), that checkpoint at world 1 for steps 4-5 in "
              f"{c_s:.1f} s; G "
              f"{', '.join(f'{g_all[k]:.3f}' for k in sorted(g_all))}; "
              f"relative G/D loss gap per step to the same 6 steps "
              f"uninterrupted at world 1 ({u_s:.1f} s) "
              f"{', '.join(f'{g:.3e}' for g in chain_gaps or [])} (tol "
              f"{DIST_LOSS_RTOL:g}) ({card})", flush=True)
        if (sorted(la) != [0, 1] or sorted(lb) != [2, 3] or sorted(lc) != [4, 5]
                or not restored_b or not restored_c
                or any(v != v or abs(v) == float("inf") for v in values)
                or chain_gaps is None or not max(chain_gaps) <= DIST_LOSS_RTOL):
            raise SystemExit(f"[tp] the trainer's hand-offs between world 1 "
                             f"and (1, 2) went wrong: {chain}, "
                             f"{uninterrupted}, {restored_b}, {restored_c}")
        missing = [k for k in counters if launches_b[k] <= 0]
        if missing:
            raise SystemExit(f"[tp] the (1, 2) trainer's rank 0 never launched "
                             f"{missing}")
    finally:
        # A failed hand-off still waits for the encoder's ranks to end.
        enc_thread.join()

    if "error" in enc_result:
        raise SystemExit(f"[tp] the (1, 2) encoder trainer failed: "
                         f"{enc_result['error']}")
    enc_s = enc_result["seconds"]
    enc_run = next((work / "enc").iterdir())
    logged = {"train/loss": [], "val/loss": []}
    for line in (enc_run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"] in logged:
            logged[rec["tag"]].append(rec["value"])
    enc_losses = logged["train/loss"] + logged["val/loss"]
    # The first voiced epoch of [encoder-trainer]'s world-1 run: the same
    # corpus, configuration, seed and precision settings.
    want = (world1_encoder["train_loss"][:len(logged["train/loss"])]
            + world1_encoder["val_loss"][:len(logged["val/loss"])])
    enc_gaps = ([abs(a - b) / abs(b) for a, b in zip(enc_losses, want)]
                if len(want) == len(enc_losses) else None)
    enc_launches = _logged_launches(enc_run / "log.txt")
    report["encoder"] = {"seconds": enc_s, "losses": enc_losses,
                         "world1_losses": want, "gaps": enc_gaps,
                         "rank0_launches": enc_launches}
    print(f"[tp] train.encoder --model_parallel 2, 1 voiced epoch in "
          f"{enc_s:.1f} s beside the trainer runs, train and val losses "
          f"{enc_losses}, relative gap to world 1's first epoch "
          f"{', '.join(f'{g:.3e}' for g in enc_gaps or [])} (tol "
          f"{DIST_LOSS_RTOL:g}), rank 0 launches {enc_launches} ({card})",
          flush=True)
    if (not (enc_run / ".done").exists() or not logged["train/loss"]
            or not logged["val/loss"] or enc_gaps is None
            or not max(enc_gaps) <= DIST_LOSS_RTOL
            or enc_launches["fused_adamw"] <= 0):
        raise SystemExit(f"[tp] the (1, 2) encoder trainer went wrong: "
                         f"{enc_losses} against world 1's {want}, "
                         f"{enc_launches}")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"[tp] phase took {report['seconds']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return report


def _weights_of_init(torch):
    """The tiny setup's seeded initial weights (the tiny runs' ``init``)."""
    from ste_gan_torch.parallel.multiprocess import tiny_setup
    from ste_gan_torch.train.gan import init_state, state_tree

    cfg_t, models_t = tiny_setup("cuda")
    return _weights(state_tree(models_t, init_state(cfg_t, models_t)))


def check_sp(torch, card):
    """``[sp]``: time-sharded synthesis (``python -m
    ste_gan_torch.parallel.sequence_parallel``) of the shipped generator
    (seeded weights, f32, TF32 off), one launch of 4 gloo ranks sharing
    the card: over the first 2 at 500 and 1,500 frames and over all 4 at
    200 (blocks of 50 frames under the 128-frame context: three hops), each
    against one-device synthesis
    (``EMGSynthesizer.synthesize``) within ``INFER_TOL`` of its largest
    value; ms per call against the same function on one device."""
    from ste_gan_torch.infer import EMGSynthesizer
    from ste_gan_torch.parallel.launch import run_ranks
    from ste_gan_torch.parallel.sequence_parallel import (
        seeded_case, shipped_generator, synthesize_time_sharded)

    work = ROOT / "build" / "chip_smoke_sp"
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, gen = shipped_generator("cuda")
    synth = EMGSynthesizer(gen, device="cuda")
    report = {}
    cases = ((2, 500), (2, 1500), (4, 200))
    out = work / "ranks"
    run_ranks([sys.executable, "-m",
               "ste_gan_torch.parallel.sequence_parallel", "--cases",
               *(f"{r}:{f}" for r, f in cases), "--out", str(out),
               "--dist_backend", "gloo", "--timeout_s", "300"],
              max(r for r, _ in cases), out / "logs", 600, env=_dist_env())
    stats = json.loads((out / "sp_stats.json").read_text())
    for ranks, f in cases:
        feats, sess = seeded_case(f)
        want = synth.synthesize(feats, sess)
        got = np.load(out / f"sp_{ranks}x{f}.npy")
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        one_ms = cuda_time(lambda: synthesize_time_sharded(
            gen, feats, sess), reps=3, warmup=1)
        local_t = -(-f // ranks)
        row = {"ranks": ranks, "frames": f, "local_t": local_t,
               "hops": min(-(-128 // local_t), ranks - 1),
               "shape": list(got.shape), "rel": rel,
               "ms": stats[f"{ranks}x{f}"]["ms"], "one_device_ms": one_ms}
        report[f"{ranks}x{f}"] = row
        print(f"[sp] {ranks} gloo ranks sharing the card, {f} frames "
              f"(blocks of {local_t}, {row['hops']} hop(s)): within "
              f"{rel:.3e} of one device (tol {INFER_TOL:g}, TF32 off); "
              f"{row['ms']:.2f} ms per call against {one_ms:.2f} ms on "
              f"one device ({card})", flush=True)
        if not (got.shape == want.shape and rel <= INFER_TOL):
            raise SystemExit(f"[sp] time-sharded synthesis differs: {row}")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"[sp] phase took {report['seconds']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# [pp], [ep], [axes]: pipeline and expert parallelism and the axes worker
# ---------------------------------------------------------------------------

#: Steps of [pp]'s trainer step, pipelined and at world 1 (the last one
#: times the point-to-point messages), and of its control.
PP_STEPS, PP_CONTROL_STEPS = 3, 1
#: Forward and gradients of one full-width fold, pipelined against world 1
#: at the pipeline's microbatch shapes: max |difference| / max |world 1|
#: per tensor (a conv bias that feeds a BatchNorm, whose true gradient is
#: 0, against its weight's gradient). The outputs and the loss are held to
#: it against the whole-batch call too.
PP_GRAD_RTOL = 1e-5
#: The pipelined trainer CLI's first voiced epoch against [encoder-trainer]'s
#: world 1 (relative).
PP_EPOCH_RTOL = 1e-6
#: Steps of each [ep] run, and the capacity factor at which picks drop.
EP_STEPS, EP_DROPPING_FACTOR = 2, 0.5
#: [ep]'s losses against world 1's (relative). The picks dropped must equal
#: world 1's in the first step, from the same weights; after an update a
#: data axis's own rounding (a gradient summed from two halves, BatchNorm
#: statistics from all-reduced sums) may move a pick that lies within
#: rounding of a tie, so later steps' counts are reported.
EP_LOSS_RTOL = 1e-4
#: [axes]: the JAX worker test's tolerances (tests/test_multiprocess_axes.py).
AXES_FWD_TOL = dict(rtol=1e-4, atol=2e-6)
AXES_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
#: The encoder's AdamW hyperparameters (``train.encoder.make_optimizer``).
ENC_HYPER = dict(lr=3e-4, b1=0.9, b2=0.999, weight_decay=1e-5)


def _rank_program(fn: str, *args) -> list:
    """A rank command that runs ``chip_smoke.<fn>(*args)``."""
    return [sys.executable, "-c",
            f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.{fn}(*sys.argv[1:])",
            *[str(a) for a in args]]


def _bn_fed(name: str) -> bool:
    """A conv bias that a BatchNorm follows (no true gradient)."""
    parts = name.split(".")
    return (parts[0] == "conv_blocks" and parts[-1] == "bias"
            and parts[2] in ("conv1", "conv2", "residual_path"))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_setup(enc_yaml: str, **params):
    """A rank of [pp] or [ep]: gloo on this card, the worker's
    ``--deterministic`` settings (TF32 off, deterministic kernels: a rerun
    of the same call agrees bit for bit, so only the parallel layout can
    part two runs); a factory of copies of one seeded full-width encoder,
    a folded batch of 80 windows (the 128k packing budget) and its
    ``max_samples``."""
    import copy

    import torch

    from ste_gan_torch.config import load_config
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.parallel import mesh
    from ste_gan_torch.parallel.multiprocess import deterministic
    from ste_gan_torch.train.encoder_data import fold_encoder_batch

    deterministic()
    mesh.init_distributed("gloo", 600, "cuda")
    cfg = load_config(emg_enc_cfg=str(ROOT / "configs" / "emg_encoder"
                                      / enc_yaml))
    cfg.emg_encoder.params = dict(cfg.emg_encoder.params, **params)
    template = init_emg_encoder(cfg, torch.float32,
                                torch.Generator().manual_seed(0)).cuda()

    def fresh():
        return copy.deepcopy(template)

    host = fold_encoder_batch(encoder_items(np.random.default_rng(8),
                                            128_000),
                              n_win=80, max_samples=160).as_dict()
    batch = {k: torch.from_numpy(np.asarray(v)).cuda()
             for k, v in host.items()}
    return fresh, batch, 160


def _params_host(model) -> dict:
    return {n: p.detach().cpu().numpy().astype(np.float64)
            for n, p in model.named_parameters()}


def _held_bytes(state, model) -> int:
    """Train-state bytes a rank holds: its parameters, both AdamW moments
    and the buffers."""
    return sum(t.numel() * t.element_size() for t in (
        *state.opt.params, *state.opt.exp_avg, *state.opt.exp_avg_sq,
        *model.buffers()))


def pp_rank(out: str) -> None:
    """One of [pp]'s two gloo ranks (``check_pp``), full width
    (``conv_transformer.yaml``), TF32 off, 2 stages of 3 layers, 80
    microbatches of one window. World 1 runs twice: as the one-device
    call (``__call__``, and the trainer step as the CLI runs it) and as the
    one-device call at the pipeline's microbatch shapes (``pipelined`` over
    a one-stage layout: the stack applied one microbatch at a time, JAX's
    oracle in ``tests/test_pipeline_parallel.py``). Only the latter rounds
    each layer's products as the stages do, so only it can agree to float
    precision: at full width, a few of the ReLUs' ~25 M pre-activations
    per layer lie within rounding of 0, and a sign that flips moves a
    weight gradient by one token's share.

    1. one fold, train mode (shift 3, dropout masks from one seed): the
       pipelined outputs, loss and gradients (summed by
       ``allreduce_stage_grads_``) against both world-1 calls;
    2. the trainer's step (``make_encoder_train_step``) ``PP_STEPS`` times,
       pipelined and at world 1 both ways, from the same seeded weights:
       losses, ms/step, point-to-point messages, bytes and (last step) ms,
       state bytes, and the gathered weights' deviation from each world
       1's;
    3. the control: ``PP_CONTROL_STEPS`` pipelined steps without the
       stage-group sum of the replicated gradients, against world 1 at
       microbatch shapes.

    Writes ``pp_r{rank}.json``."""
    import torch
    import torch.distributed as dist

    from ste_gan_torch.ops import kernel_launches
    from ste_gan_torch.parallel import pipeline_parallel as pp
    from ste_gan_torch.train import encoder as tenc

    fresh, batch, max_samples = _rank_setup("conv_transformer.yaml")
    dev = batch["emg_windows"].device
    rank = dist.get_rank()
    stages = pp.create_stage_mesh(2)
    alone = pp.StageMesh(None, None, None)
    m, shift = batch["emg_windows"].shape[0], 3
    report = {"stage": stages.stage_rank, "microbatches": m}

    def fold(model, mesh):
        """Outputs, loss and {name: gradient} of one train-mode fold;
        ``mesh`` None: ``__call__``."""
        gen = torch.Generator(dev).manual_seed(5)
        if mesh is None:
            su, ph = model(batch["emg_windows"], train=True, shift=shift,
                           generator=gen)
            params = list(model.parameters())
        else:
            pp.shard_stages_(model, mesh)
            su, ph = model.pipelined(pp.microbatch_rows(
                batch["emg_windows"], m, mesh), mesh, m, train=True,
                shift=shift, generator=gen)
            params = sum(pp.stage_parameters(model, mesh), [])
        loss, _ = tenc._train_loss(model, su, ph, batch, max_samples, 0)
        grads = list(torch.autograd.grad(
            loss if mesh is None else pp.last_stage_only(loss, mesh),
            params, materialize_grads=True))
        if mesh is not None:
            n_rep = len(pp.stage_parameters(model, mesh)[0])
            pp.allreduce_stage_grads_(grads[:n_rep], grads[n_rep:], mesh)
        names = {id(p): n for n, p in model.named_parameters()}
        return (su.detach(), ph.detach(), float(loss),
                {names[id(p)]: g for p, g in zip(params, grads)})

    def against(got, want):
        su, ph, loss, grads = got
        su1, ph1, loss1, grads1 = want
        rel = {}
        for n, g in grads.items():
            ref = grads1[n.rsplit(".", 1)[0] + ".weight"] if _bn_fed(n) \
                else grads1[n]
            rel[n] = float((g - grads1[n]).abs().max() / ref.abs().max())
        return {"outputs_rel": max(float((a - b).abs().max()
                                         / b.abs().max())
                                   for a, b in ((su, su1), (ph, ph1))),
                "loss_rel": abs(loss - loss1) / abs(loss1),
                "grads_rel": max(rel.values()), "grad_tensors": len(rel),
                "worst_grad": max(rel, key=rel.get)}

    # 1. One fold: forward and gradients.
    init = _params_host(fresh())
    piped = fold(fresh(), stages)
    report["fold"] = against(piped, fold(fresh(), alone))
    report["fold_full_batch"] = against(piped, fold(fresh(), None))
    del piped

    # 2. The trainer's step: pipelined, and at world 1 both ways.
    def trainer_steps(mesh, n, on_step=None):
        model = fresh()
        if mesh is None:
            state, pipeline = tenc.init_train_state(model), None
        else:
            pp.shard_stages_(model, mesh)
            state = tenc.init_train_state(model, params=sum(
                pp.stage_parameters(model, mesh), []))
            pipeline = (mesh, m)
        tenc.set_learning_rate(state.opt, 3e-4)
        step = tenc.make_encoder_train_step(model, max_samples,
                                            pipeline=pipeline)
        losses, ms, comm, snapshot = [], [], [], {}
        for i in range(n):
            if on_step is not None:
                on_step(i)
            if i == PP_CONTROL_STEPS and mesh is alone:
                snapshot = _params_host(model)
            _sync(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            comm.append((stages.comm.calls, stages.comm.bytes,
                         stages.comm.seconds))
        weights = {k: v.cpu().numpy().astype(np.float64) for k, v in
                   pp.gather_stage_state_dict(model, mesh or alone).items()
                   if k in init}
        return (weights, losses, ms, comm, snapshot,
                _held_bytes(state, model))

    one, losses1, ms1, _, _, one_bytes = trainer_steps(None, PP_STEPS)
    one_mb, losses_mb, ms_mb, _, at_control, _ = trainer_steps(alone,
                                                               PP_STEPS)
    before = kernel_launches()

    def time_last(i):
        stages.comm.timed = i == PP_STEPS - 1

    got, losses, ms, comm, _, held = trainer_steps(stages, PP_STEPS,
                                                   time_last)
    stages.comm.timed = False
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    calls = [b[0] - a[0] for a, b in zip([(0, 0, 0.0)] + comm, comm)]
    nbytes = [b[1] - a[1] for a, b in zip([(0, 0, 0.0)] + comm, comm)]
    report["steps"] = {
        "losses": losses, "world1_losses": losses1,
        "world1_microbatch_losses": losses_mb,
        "loss_gaps": [abs(a - b) / abs(b) for a, b in
                      zip(losses, losses_mb)],
        "loss_gaps_full_batch": [abs(a - b) / abs(b) for a, b in
                                 zip(losses, losses1)],
        "ms": ms, "world1_ms": ms1, "world1_microbatch_ms": ms_mb,
        "messages_per_step": calls[-1], "mb_per_step": nbytes[-1] / 2**20,
        "p2p_ms_last_step": 1e3 * comm[-1][2],
        "weight_deviation": _weight_deviation(got, one_mb, init),
        "weight_deviation_full_batch": _weight_deviation(got, one, init),
        "state_bytes": held, "world1_state_bytes": one_bytes,
        "launches": launches}
    del got, one, one_mb

    # 3. The control: no stage-group sum of the replicated gradients.
    real = pp.sum_over_stages_
    pp.sum_over_stages_ = lambda grads, mesh: None
    try:
        got, ctrl_losses, _, _, _, _ = trainer_steps(stages,
                                                     PP_CONTROL_STEPS)
    finally:
        pp.sum_over_stages_ = real
    report["control"] = {"losses": ctrl_losses,
                         "weight_deviation": _weight_deviation(
                             got, at_control, init)}
    Path(out).mkdir(parents=True, exist_ok=True)
    (Path(out) / f"pp_r{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def ep_rank(out: str, data: str, expert: str) -> None:
    """One rank of an [ep] run (``check_ep``): the full-width MoE encoder
    (``conv_transformer_moe.yaml``), TF32 off, at ``(data, expert)``; at
    the configuration's capacity factor and at ``EP_DROPPING_FACTOR``,
    ``EP_STEPS`` trainer steps at world 1 and at the layout from the same
    seeded weights (losses, picks dropped, ms/step, state bytes, the
    collectives' count and MB per step, then one step more that times them);
    at a data axis above 1 also the control: global slot offsets replaced
    by local ones. Writes ``ep_{data}x{expert}_r{rank}.json``."""
    import torch
    import torch.distributed as dist

    from ste_gan_torch.models import moe as moe_mod
    from ste_gan_torch.ops import kernel_launches
    from ste_gan_torch.parallel import expert_parallel as ep
    from ste_gan_torch.parallel import mesh
    from ste_gan_torch.parallel.tensor_parallel import CommStats
    from ste_gan_torch.train import encoder as tenc

    d, e = int(data), int(expert)
    factors = {"config": None, "dropping": EP_DROPPING_FACTOR}
    fresh_at, batch = {}, None
    for name, cf in factors.items():
        kw = {} if cf is None else {"moe_capacity_factor": cf}
        fresh_at[name], batch, max_samples = _rank_setup(
            "conv_transformer_moe.yaml", **kw)
    dev = batch["emg_windows"].device
    rank = dist.get_rank()
    layout = ep.create_expert_mesh(d, e)
    grads_comm = CommStats()
    allreduce = mesh.allreduce_grads_

    def counted_allreduce(grads, group, average=True):
        """``mesh.allreduce_grads_``, counted in ``grads_comm``."""
        grads = list(grads)
        if group is None:
            return grads
        grads_comm.calls += 1
        grads_comm.bytes += 4 * sum(g.numel() for g in grads)
        if grads_comm.timed:
            _sync(dev)
        t0 = time.perf_counter()
        allreduce(grads, group, average)
        if grads_comm.timed:
            _sync(dev)
            grads_comm.seconds += time.perf_counter() - t0
        return grads

    mesh.allreduce_grads_ = counted_allreduce

    def blocks(model):
        return [layer.moe_ffn for layer in model.transformer.layers]

    def run(model, group, n):
        state = tenc.init_train_state(model)
        tenc.set_learning_rate(state.opt, 3e-4)
        step = tenc.make_encoder_train_step(model, max_samples, group=group)
        losses, dropped, ms = [], [], []
        for _ in range(n):
            _sync(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            dropped.append(int(sum(int(b.dropped) for b in blocks(model))))
            ms.append(1e3 * (time.perf_counter() - t0))
        return state, step, losses, dropped, ms

    report = {"data": d, "expert": e}
    for name in factors:
        one = fresh_at[name]()
        s1, _, losses1, dropped1, ms1 = run(one, None, EP_STEPS)
        one_bytes = _held_bytes(s1, one)
        del one, s1
        model = fresh_at[name]()
        ep.shard_moe_module_(model, layout)
        for b in blocks(model):
            b.comm = layout.comm
        before = kernel_launches()
        state, step, losses, dropped, ms = run(model, layout.data, EP_STEPS)
        launches = {k: v - before[k] for k, v in kernel_launches().items()}
        calls, nbytes = layout.comm.calls, layout.comm.bytes
        g_calls, g_bytes = grads_comm.calls, grads_comm.bytes
        layout.comm.timed = grads_comm.timed = True
        layout.comm.seconds = grads_comm.seconds = 0.0
        step(state, batch)
        _sync(dev)
        layout.comm.timed = grads_comm.timed = False
        report[name] = {
            "losses": losses, "world1_losses": losses1,
            "loss_gaps": [abs(a - b) / abs(b) for a, b in
                          zip(losses, losses1)],
            "dropped": dropped, "world1_dropped": dropped1,
            "ms": ms, "world1_ms": ms1,
            "moe_collectives_per_step": calls / EP_STEPS,
            "moe_mb_per_step": nbytes / EP_STEPS / 2**20,
            "grad_allreduce_mb_per_step": g_bytes / EP_STEPS / 2**20,
            "collectives_per_step": (calls + g_calls) / EP_STEPS,
            "moe_comm_ms": 1e3 * layout.comm.seconds,
            "grad_allreduce_ms": 1e3 * grads_comm.seconds,
            "state_bytes": _held_bytes(state, model),
            "world1_state_bytes": one_bytes, "launches": launches}
        layout.comm.calls = layout.comm.bytes = 0
        grads_comm.calls = grads_comm.bytes = 0
        del model, state, step
    if d > 1:
        real = moe_mod._gather

        def local_offsets(counts, group, comm):
            every = real(counts, group, comm)
            mine = torch.zeros_like(every)
            me = dist.get_rank(group)
            mine[me] = every[me]
            return mine

        moe_mod._gather = local_offsets
        try:
            model = fresh_at["dropping"]()
            _, _, losses, dropped, _ = run(model, layout.data, EP_STEPS)
        finally:
            moe_mod._gather = real
        report["control"] = {"losses": losses, "dropped": dropped}
    mesh.allreduce_grads_ = allreduce
    Path(out).mkdir(parents=True, exist_ok=True)
    (Path(out) / f"ep_{d}x{e}_r{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def check_pp_ep_kernels(torch, fa, card):
    """AdamW, kernel against plain (``adamw_row``, 1e-6), at the per-rank
    sets [pp], [ep] and [axes] update: a stage's set of the full-width
    ``conv_transformer.yaml`` encoder at 2 and 3 stages (the frontend and
    heads, and 3 or 2 layers; every stage's set has the same shapes), an
    expert rank's set of ``conv_transformer_moe.yaml`` at expert axis 2 (2
    of 4 experts per block, the rest whole), and the axes worker's sets (4
    of its 8 layers; the router and 4 of its 8 experts). Shapes are read
    from modules the port's own functions cut, built on the meta device.
    Not counted as launches."""
    import torch.nn as nn

    from ste_gan_torch.config import load_config
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.parallel import expert_parallel as ep
    from ste_gan_torch.parallel import multiprocess_axes as axes
    from ste_gan_torch.parallel import pipeline_parallel as pp
    from ste_gan_torch.parallel.tensor_parallel import Mesh2D

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(12)
    sets = {}
    for yaml_name in ("conv_transformer.yaml", "conv_transformer_moe.yaml"):
        cfg = load_config(emg_enc_cfg=str(ROOT / "configs" / "emg_encoder"
                                          / yaml_name))
        with torch.device("meta"):
            model = init_emg_encoder(cfg, torch.float32)
        if yaml_name == "conv_transformer.yaml":
            for s in (2, 3):
                mesh = pp.StageMesh(None, None, None, stage_rank=s - 1,
                                    num_stages=s)
                rep, own = pp.stage_parameters(model, mesh)
                sets[f"encoder_stage_of_{s}"] = [p.shape for p in rep + own]
        else:
            ep.shard_moe_module_(model, Mesh2D(None, None, None, 0, 1, 1, 2))
            sets["moe_encoder_expert_of_2"] = [p.shape for p in
                                               model.parameters()]
    with torch.device("meta"):
        stack = axes.pipeline_setup()[0]
        moe = axes.moe_setup()[0]
    _, own = pp.stage_parameters(stack, pp.StageMesh(
        None, None, None, stage_rank=1, num_stages=2))
    sets["axes_pipeline_stage_of_2"] = [p.shape for p in own]
    holder = nn.Module()
    holder.moe_ffn = moe
    ep.shard_moe_module_(holder, Mesh2D(None, None, None, 0, 1, 1, 2))
    sets["axes_expert_of_2"] = [p.shape for p in moe.parameters()]
    rows = []
    for label, shapes in sets.items():
        hyper = (dict(ENC_HYPER, lr=axes.LR) if label.startswith("axes")
                 else ENC_HYPER)
        row = {"set": label, **adamw_row(torch, fa, shapes, gen, **hyper)}
        rows.append(row)
        print(f"[pp/ep/axes] fused_adamw at {label} ({row['params']} params, "
              f"{row['leaves']} leaves): max|err| {row['max_abs_err']:.3e} "
              f"(tol {row['tol']:g}) kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.4f} ms library {row['library_ms']:.4f} ms "
              f"bound {row['bound_ms']:.4f} ms ({card})", flush=True)
    return {"adamw": rows, "seconds": time.perf_counter() - t0,
            "summary": {"shapes": len(rows), "max_abs_err": max(
                r["max_abs_err"] for r in rows)}}


def check_pp(torch, card, world1_encoder):
    """``[pp]``: pipeline parallelism on the one card, gloo ranks sharing
    it. ``pp_rank`` on two ranks: the fold's forward and gradients within
    ``PP_GRAD_RTOL`` of world 1 at microbatch shapes (outputs and loss of
    the whole-batch call too); the trainer step's losses within
    ``DIST_LOSS_RTOL`` and weights within ``DIST_WEIGHT_RTOL`` of both
    world-1 runs; the control leaving world 1's weights by more than
    ``DIST_WEIGHT_RTOL`` on a rank. Beside it, one voiced epoch of
    ``train.encoder --pipeline_stages 2`` on the [encoder-trainer] corpus,
    whose train and validation losses must be within ``PP_EPOCH_RTOL`` of
    that run's first epoch (``world1_encoder``). Two ranks on one card:
    correctness and the messages' cost, not scaling."""
    from ste_gan_torch.parallel.launch import run_ranks

    work = ROOT / "build" / "chip_smoke_pp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    enc_data = ROOT / "build" / "chip_smoke_encoder" / "synthetic.yaml"
    errors, seconds = {}, {}

    def launch(name, cmd):
        t0 = time.perf_counter()
        try:
            run_ranks(cmd, 2, work / f"{name}_logs", 900, env=_dist_env())
        except Exception as err:  # reported, and fatal, below
            errors[name] = err
        seconds[name] = time.perf_counter() - t0

    threads = [
        threading.Thread(target=launch, args=(
            "worker", _rank_program("pp_rank", work / "worker"))),
        threading.Thread(target=launch, args=("trainer", [
            sys.executable, "-m", "ste_gan_torch.train.encoder", "--config",
            str(ROOT / "configs" / "ste_gan_base_gantts.yaml"), "--data",
            str(enc_data), "--emg_enc_cfg",
            str(ROOT / "configs" / "emg_encoder" / "conv_transformer.yaml"),
            "--exp_dir", str(work / "enc"), "--num_epochs", "1",
            "--pipeline_stages", "2", "--dist_backend", "gloo",
            "--dist_timeout_s", "300"]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise SystemExit(f"[pp] runs failed: {errors}")
    ranks = [json.loads((work / "worker" / f"pp_r{r}.json").read_text())
             for r in range(2)]
    report = {"ranks": ranks, "seconds_side_by_side": seconds}
    for r in ranks:
        fold, full, steps = r["fold"], r["fold_full_batch"], r["steps"]
        print(f"[pp] stage {r['stage']} of 2 (gloo, one card, full width, "
              f"{r['microbatches']} microbatches of one window, TF32 off): "
              f"one fold against world 1 at microbatch shapes: outputs "
              f"{fold['outputs_rel']:.3e}, loss {fold['loss_rel']:.3e}, "
              f"gradients {fold['grads_rel']:.3e} at worst "
              f"({fold['worst_grad']}, {fold['grad_tensors']} tensors; tol "
              f"{PP_GRAD_RTOL:g}); against the whole-batch call: outputs "
              f"{full['outputs_rel']:.3e}, loss {full['loss_rel']:.3e}, "
              f"gradients {full['grads_rel']:.3e} ({full['worst_grad']}; "
              f"ReLU kinks); {PP_STEPS} trainer steps: ms/step "
              f"{', '.join(f'{x:.1f}' for x in steps['ms'])} (world 1 "
              f"{', '.join(f'{x:.1f}' for x in steps['world1_ms'])}; at "
              f"microbatch shapes "
              f"{', '.join(f'{x:.1f}' for x in steps['world1_microbatch_ms'])}"
              f"), loss gaps "
              f"{', '.join(f'{g:.3e}' for g in steps['loss_gaps'])} (whole "
              f"batch {', '.join(f'{g:.3e}' for g in steps['loss_gaps_full_batch'])}"
              f"), weight deviation {steps['weight_deviation']:.3e} (whole "
              f"batch {steps['weight_deviation_full_batch']:.3e}; tol "
              f"{DIST_WEIGHT_RTOL:g}); {steps['messages_per_step']} messages "
              f"per step, {steps['mb_per_step']:.1f} MB, "
              f"{steps['p2p_ms_last_step']:.1f} ms of sends and receives in "
              f"the last step; state held {steps['state_bytes'] / 2**20:.1f} "
              f"MB (world 1 {steps['world1_state_bytes'] / 2**20:.1f}); "
              f"launches {steps['launches']}; control without the "
              f"stage-group sum: weight deviation "
              f"{r['control']['weight_deviation']:.3e} ({card})", flush=True)
        if not (fold["outputs_rel"] <= PP_GRAD_RTOL
                and fold["loss_rel"] <= PP_GRAD_RTOL
                and fold["grads_rel"] <= PP_GRAD_RTOL
                and full["outputs_rel"] <= PP_GRAD_RTOL
                and full["loss_rel"] <= PP_GRAD_RTOL
                and max(steps["loss_gaps"]
                        + steps["loss_gaps_full_batch"]) <= DIST_LOSS_RTOL
                and steps["weight_deviation"] <= DIST_WEIGHT_RTOL
                and steps["weight_deviation_full_batch"] <= DIST_WEIGHT_RTOL
                and steps["launches"]["fused_adamw"] == PP_STEPS):
            raise SystemExit(f"[pp] the pipelined encoder left world 1: {r}")
    if not any(r["control"]["weight_deviation"] > DIST_WEIGHT_RTOL
               for r in ranks):
        raise SystemExit("[pp] the weight gate misses ranks that skip the "
                         "stage-group sum of the replicated gradients")

    run = next((work / "enc").iterdir())
    logged = {"train/loss": [], "val/loss": []}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"] in logged:
            logged[rec["tag"]].append(rec["value"])
    got = logged["train/loss"] + logged["val/loss"]
    want = (world1_encoder["train_loss"][:len(logged["train/loss"])]
            + world1_encoder["val_loss"][:len(logged["val/loss"])])
    gaps = ([abs(a - b) / abs(b) for a, b in zip(got, want)]
            if len(got) == len(want) else None)
    launches = _logged_launches(run / "log.txt")
    held = [ln for ln in (run / "log.txt").read_text().splitlines()
            if "Train state held by this rank" in ln]
    report["trainer"] = {"seconds": seconds["trainer"], "losses": got,
                         "world1_losses": want, "gaps": gaps,
                         "rank0_launches": launches,
                         "rank0_state_line": held[-1] if held else None}
    print(f"[pp] train.encoder --pipeline_stages 2, 1 voiced epoch in "
          f"{seconds['trainer']:.1f} s beside the worker: train and val "
          f"losses {got}, relative gap to world 1's first epoch "
          f"{', '.join(f'{g:.3e}' for g in gaps or [])} (tol "
          f"{PP_EPOCH_RTOL:g}); rank 0 launches {launches}; "
          f"{held[-1].split(' - ')[-1] if held else ''} ({card})", flush=True)
    if (not (run / ".done").exists() or gaps is None or not got
            or not max(gaps) <= PP_EPOCH_RTOL
            or launches["fused_adamw"] <= 0):
        raise SystemExit(f"[pp] the pipelined encoder trainer went wrong: "
                         f"{got} against world 1's {want}, {launches}")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"[pp] phase took {report['seconds']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return report


def check_ep_axes(torch, card):
    """``[ep]`` and ``[axes]`` side by side on the one card, gloo ranks
    sharing it. [ep]: ``ep_rank`` at ``(data, expert) = (1, 2)`` and
    ``(2, 1)``: losses within ``EP_LOSS_RTOL`` of world 1's and the first
    step's picks dropped equal to world 1's, at the configuration's
    capacity and at ``EP_DROPPING_FACTOR`` (where picks must drop); the
    control (local slot offsets, at (2, 1) and the dropping factor) must
    change the first step's picks dropped or a loss beyond
    ``EP_LOSS_RTOL``. [axes]: ``python -m
    ste_gan_torch.parallel.multiprocess_axes`` in both modes on two
    processes against the module's one-process ``oracle`` on this card
    (forward ``AXES_FWD_TOL``, gradients ``AXES_GRAD_TOL``, the weights
    after the AdamW step within 2 lr), the processes' dumps equal."""
    from ste_gan_torch.parallel import multiprocess_axes as axes
    from ste_gan_torch.parallel.launch import run_ranks

    work = ROOT / "build" / "chip_smoke_ep"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    errors, seconds = {}, {}

    def launch(name, cmd):
        t0 = time.perf_counter()
        try:
            run_ranks(cmd, 2, work / f"{name}_logs", 900, env=_dist_env())
        except Exception as err:  # reported, and fatal, below
            errors[name] = err
        seconds[name] = time.perf_counter() - t0

    jobs = {f"ep_{d}x{e}": _rank_program("ep_rank", work / "ep", d, e)
            for d, e in ((1, 2), (2, 1))}
    for mode in ("pipeline", "expert"):
        jobs[f"axes_{mode}"] = [
            sys.executable, "-m", "ste_gan_torch.parallel.multiprocess_axes",
            "--mode", mode, "--out", str(work / mode), "--dist_backend",
            "gloo", "--timeout_s", "300"]
    threads = [threading.Thread(target=launch, args=item)
               for item in jobs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise SystemExit(f"[ep]/[axes] runs failed: {errors}")
    report = {"seconds_side_by_side": seconds, "ep": {}, "axes": {}}
    for d, e in ((1, 2), (2, 1)):
        ranks = [json.loads((work / "ep" / f"ep_{d}x{e}_r{r}.json")
                            .read_text()) for r in range(2)]
        report["ep"][f"{d}x{e}"] = ranks
        for r, res in enumerate(ranks):
            for name in ("config", "dropping"):
                x = res[name]
                print(f"[ep] (data, expert) = ({d}, {e}) rank {r}, capacity "
                      f"{name}: loss gaps to world 1 "
                      f"{', '.join(f'{g:.3e}' for g in x['loss_gaps'])} (tol "
                      f"{EP_LOSS_RTOL:g}); picks dropped {x['dropped']} "
                      f"(world 1 {x['world1_dropped']}); ms/step "
                      f"{', '.join(f'{v:.1f}' for v in x['ms'])} (world 1 "
                      f"{', '.join(f'{v:.1f}' for v in x['world1_ms'])}); "
                      f"{x['collectives_per_step']:.0f} collectives per step, "
                      f"MoE {x['moe_mb_per_step']:.3f} MB + gradient "
                      f"all-reduce {x['grad_allreduce_mb_per_step']:.1f} MB; "
                      f"timed step: MoE {x['moe_comm_ms']:.1f} ms, all-reduce "
                      f"{x['grad_allreduce_ms']:.1f} ms; state held "
                      f"{x['state_bytes'] / 2**20:.1f} MB (world 1 "
                      f"{x['world1_state_bytes'] / 2**20:.1f}) ({card})",
                      flush=True)
                if not (max(x["loss_gaps"]) <= EP_LOSS_RTOL
                        and x["dropped"][0] == x["world1_dropped"][0]
                        and x["launches"]["fused_adamw"] == EP_STEPS):
                    raise SystemExit(f"[ep] ({d}, {e}) left world 1: {x}")
            if not sum(res["dropping"]["world1_dropped"]):
                raise SystemExit("[ep] no pick dropped at the dropping "
                                 "capacity factor")
            if "control" in res:
                c, w = res["control"], res["dropping"]
                gap = max(abs(a - b) / abs(b) for a, b in
                          zip(c["losses"], w["world1_losses"]))
                caught = {"dropped": c["dropped"][0] != w["world1_dropped"][0],
                          "loss": gap > EP_LOSS_RTOL}
                c["caught"], c["loss_gap"] = caught, gap
                print(f"[ep] control with local slot offsets, (2, 1): picks "
                      f"dropped {c['dropped']} (world 1 "
                      f"{w['world1_dropped']}), loss gap {gap:.3e}; caught "
                      f"by {caught} ({card})", flush=True)
                if not any(caught.values()):
                    raise SystemExit("[ep] no gate catches local slot "
                                     "offsets")

    for mode in ("pipeline", "expert"):
        out = work / mode
        want_y, want_grads, want_state = axes.oracle(mode, "cuda")
        dumps = [(np.load(out / f"fwd_p{r}.npy"),
                  dict(np.load(out / f"grads_p{r}.npz")),
                  dict(np.load(out / f"state_p{r}.npz"))) for r in range(2)]
        stats = [json.loads((out / f"stats_p{r}.json").read_text())
                 for r in range(2)]
        y, grads, state = dumps[0]
        fwd_ok = np.allclose(y, want_y, **AXES_FWD_TOL)
        grads_ok = set(grads) == set(want_grads) and all(
            np.allclose(grads[k], v, **AXES_GRAD_TOL)
            for k, v in want_grads.items())
        state_ok = set(state) == set(want_state) and all(
            np.abs(state[k] - v).max() <= 2 * axes.LR
            for k, v in want_state.items())
        equal = all(np.array_equal(a, b) for a, b in zip(
            [dumps[0][0], *dumps[0][1].values(), *dumps[0][2].values()],
            [dumps[1][0], *dumps[1][1].values(), *dumps[1][2].values()]))
        row = {"forward_max_abs": float(np.abs(y - want_y).max()),
               "grads_max_abs": max(float(np.abs(grads[k] - v).max())
                                    for k, v in want_grads.items()),
               "forward_ok": fwd_ok, "grads_ok": grads_ok,
               "state_ok": state_ok, "processes_equal": equal,
               "seconds": seconds[f"axes_{mode}"], "stats": stats}
        report["axes"][mode] = row
        print(f"[axes] {mode} on 2 processes (gloo, one card) against one "
              f"process: forward max|diff| {row['forward_max_abs']:.3e}, "
              f"gradients {row['grads_max_abs']:.3e} (within the JAX test's "
              f"tolerances: {fwd_ok}, {grads_ok}); weights after AdamW within "
              f"2 lr {state_ok}; processes' dumps equal {equal}; "
              f"{seconds[f'axes_{mode}']:.1f} s; launches per process "
              f"{[s['launches']['fused_adamw'] for s in stats]} ({card})",
              flush=True)
        if not (fwd_ok and grads_ok and state_ok and equal):
            raise SystemExit(f"[axes] {mode} left one process: {row}")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"[ep]/[axes] phase took {report['seconds']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return report


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
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t_start = time.perf_counter()
    laps = {}

    def lap(phase: str) -> None:
        """Seconds since the start at the end of ``phase``."""
        laps[phase] = time.perf_counter() - t_start
        print(f"[time] {phase} done at {laps[phase]:.1f} s", flush=True)
    build_s = build.build_all()
    print(f"[build] kernels built in {build_s:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in ptxas_summary(log):
            print(f"[build] {name}: {line}", flush=True)

    latency = check_probe(torch, build, card)
    report = {"card": card, "build_s": build_s, "probe": latency}
    conv_rows, conv_summary = check_grouped_conv(torch, gc, F)
    report["conv"] = conv_rows
    report["conv_edges"] = check_conv_edges(torch, gc)

    cfg, models, state, step, batch = tgan.main_path(seed=0)
    adamw_rows, adamw_summary = check_adamw(torch, fa, models)
    report["adamw"] = adamw_rows
    report["reference"] = check_small_reference(Config, tgan)
    report["reference_accum_eval"] = check_small_accum_and_eval(Config, tgan)
    lap("kernels and references")

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

    lap("step")
    # ---- The trainer CLI at the shipped configuration. ----
    report["trainer"] = check_trainer(torch, counters, 1e3 * sec_per_step,
                                      card)
    lap("trainer")
    # The bare step again, so that the trainer's window is bracketed by
    # bare steps of the same process.
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    after_ms = 1e3 * (time.perf_counter() - t0) / timed
    report["step"]["ms_per_step_after_trainer"] = after_ms
    print(f"[step] again after the trainer: {after_ms:.2f} ms/step ({card})",
          flush=True)

    # ---- Encoder pre-training: the DTW kernel, the narrow reference, the
    # full-width step and the encoder trainer CLI. ----
    from ste_gan_torch.config import load_config
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.ops import dtw
    from ste_gan_torch.train import encoder as tenc

    dtw_rows, dtw_summary = check_dtw(torch, dtw, latency)
    report["dtw"] = dtw_rows
    report["encoder_reference"] = check_encoder_reference(
        torch, tenc, init_emg_encoder, Config)
    report["encoder_step"] = check_encoder_step(
        torch, tenc, fa, dtw, load_config, init_emg_encoder, card)
    lap("dtw and encoder steps")
    try:
        report["encoder_trainer"] = check_encoder_trainer(
            torch, {"fused_adamw": fa.fused_adamw_,
                    "dtw": dtw.dtw_alignment_batched}, card)
        enc_launches = {mode: report["encoder_trainer"][mode]["launches"]
                        for mode in ("voiced", "mixed")}
        lap("encoder trainer")

        # ---- Synthesis, decoding and offline evaluation on the runs the
        # trainer phases wrote. ----
        report["infer"] = check_infer(torch, card,
                                      report["trainer"]["corpus"])
        lap("infer")
        report["evaluate"] = check_evaluate(
            torch, dtw, card, report["trainer"]["run_dir"],
            report["encoder_trainer"])
        lap("evaluate")

        # ---- Deployment: artifacts, int8 and the HTTP service, on the
        # same runs. ----
        report["export"], artifacts = check_export(
            torch, card, report["trainer"]["run_dir"],
            report["encoder_trainer"])
        lap("export")
        report["serve"] = check_serve(
            torch, card, report["trainer"]["run_dir"],
            report["encoder_trainer"], artifacts["generator_f32_serving"])
        lap("serve")

        # ---- Corpus preparation: the filter kernel, then the cleaning
        # and prep CLIs over a raw tree at the corpus's shapes. ----
        from ste_gan_torch.ops import iir

        report["etl"], iir_summary = check_etl(torch, iir, card, latency)
        lap("etl")
        report["prep"] = check_prep(torch, iir, card, report["etl"])
        lap("prep")

        # ---- The mixture-of-experts encoder, on the encoder phase's
        # corpora and the trainer phase's configuration. ----
        report["moe"] = check_moe(
            torch, tenc, fa, dtw, load_config, init_emg_encoder, Config,
            card, report["encoder_step"], report["encoder_trainer"],
            report["trainer"]["run_dir"])
        lap("moe")

        # ---- Data parallelism and FSDP over ranks, the launcher, the
        # trainers at 2 ranks and scale-out synthesis, on the one card. ----
        report["dist"], world1 = check_dist(torch, card, counters,
                                            report["trainer"]["run_dir"])

        # ---- Tensor parallelism: the kernels at the per-rank shapes, the
        # worker at (1, 2) full width and its control, the tiny layouts,
        # both trainers at (1, 2); then time-sharded synthesis. ----
        lap("dist")
        report["tp_kernels"] = check_tp_kernels(
            torch, gc, fa, (cfg, models))
        report["tp"] = check_tp(torch, card, counters, world1,
                                report["encoder_trainer"]["voiced"],
                                report["trainer"]["run_dir"])
        del world1
        lap("tp")
        report["sp"] = check_sp(torch, card)
        lap("sp")

        # ---- Pipeline and expert parallelism, and the axes worker: AdamW
        # at their per-rank sets, the pipelined encoder and its trainer at
        # 2 stages, the MoE encoder at (1, 2) and (2, 1), both modes of
        # the worker on two processes. ----
        report["pp_ep_kernels"] = check_pp_ep_kernels(torch, fa, card)
        report["pp"] = check_pp(torch, card,
                                report["encoder_trainer"]["voiced"])
        lap("pp")
        report["ep_axes"] = check_ep_axes(torch, card)
        lap("ep and axes")
    finally:
        for work in ("chip_smoke_trainer", "chip_smoke_encoder"):
            shutil.rmtree(ROOT / "build" / work, ignore_errors=True)

    source = {"grouped_conv_fwd": "ste_gan_torch/csrc/grouped_conv.cu",
              "grouped_conv_dx": "ste_gan_torch/csrc/grouped_conv.cu",
              "grouped_conv_dw": "ste_gan_torch/csrc/grouped_conv_dw.cu",
              "fused_adamw": "ste_gan_torch/csrc/adamw.cu"}
    replaces = {"grouped_conv_fwd": "ste_gan_tpu/ops/pallas_conv.py:147",
                "grouped_conv_dx": "ste_gan_tpu/ops/pallas_conv.py:282",
                "grouped_conv_dw": "ste_gan_tpu/ops/pallas_conv.py:158",
                "fused_adamw": "ste_gan_tpu/ops/fused_adamw.py:49"}
    #: The CUDA kernels each wrapper launches on the main path (bf16).
    cuda_kernels = {"grouped_conv_fwd": "conv_weight_layout_kernel + "
                                        "conv_fwd_wgmma_kernel",
                    "grouped_conv_dx": "conv_weight_layout_kernel + "
                                       "conv_dx_wgmma_kernel",
                    "grouped_conv_dw": "conv_dw_wgmma_kernel",
                    "fused_adamw": "adamw_multi_tensor_kernel"}
    summaries = dict(conv_summary, fused_adamw=adamw_summary)
    dist_report = report["dist"]
    fsdp_two = dist_report["two_ranks_gloo"]["fsdp"]

    def dist_launches(name):
        """Launches of ``name`` on the [dist] paths (per rank where there
        are two)."""
        return {
            "world1_nccl_dp_and_fsdp": dist_report["world1"]["launches"][name],
            "two_ranks_gloo_dp": [r[name] for r in dist_report[
                "two_ranks_gloo"]["dp"]["launches"]],
            "two_ranks_gloo_fsdp": ([r[name] for r in fsdp_two["launches"]]
                                    if "launches" in fsdp_two else None),
            "train_gan_two_ranks_rank0": dist_report["trainers"][
                "gan_rank0_launches"][name],
            "train_encoder_two_ranks_rank0": dist_report["trainers"][
                "encoder_rank0_launches"][name]}

    dist_held = dist_report["kernels_at_dist_shapes"]["summary"]
    tp_report = report["tp"]
    tp_held = report["tp_kernels"]["summary"]

    def tp_launches(name):
        """Launches of ``name`` on the [tp] paths, per rank where a run
        has several."""
        return {
            "worker_1x2_full_width": [r[name] for r in tp_report[
                "full_1x2"]["launches"]],
            "worker_1x2_tiny_fsdp": [r[name] for r in tp_report[
                "tiny_1x2_fsdp"]["launches"]],
            "worker_2x2_tiny": [r[name] for r in tp_report["tiny_2x2"][
                "launches"]],
            "train_gan_1x2_rank0": tp_report["trainer"]["rank0_launches"][
                name],
            "train_encoder_1x2_rank0": tp_report["encoder"][
                "rank0_launches"][name]}

    pp_ranks = report["pp"]["ranks"]
    ep_runs = report["ep_axes"]["ep"]
    axes_runs = report["ep_axes"]["axes"]

    def axes_family_launches(name):
        """Launches of ``name`` on the [pp], [ep] and [axes] paths, per
        rank: the pipelined trainer steps of the worker and the trainer
        CLI's rank 0; each (data, expert) layout's steps at both capacity
        factors; each mode of the axes worker."""
        return {
            "pp": {"worker_steps": [r["steps"]["launches"][name]
                                    for r in pp_ranks],
                   "train_encoder_s2_rank0": report["pp"]["trainer"][
                       "rank0_launches"][name]},
            "ep": {layout: [sum(r[f]["launches"][name]
                                for f in ("config", "dropping"))
                            for r in ranks]
                   for layout, ranks in ep_runs.items()},
            "axes": {mode: [s["launches"][name] for s in row["stats"]]
                     for mode, row in axes_runs.items()}}

    kernels = [{"name": name, "route": "cuda", "source": source[name],
                "kernel": cuda_kernels[name], "replaces": replaces[name],
                "launches": launches[name],
                "trainer_launches": report["trainer"]["launches"][name],
                "dist_launches": dist_launches(name),
                "dist_shapes_held": dist_held[name],
                "tp_launches": tp_launches(name),
                "tp_shapes_held": tp_held[name],
                "pp_ep_axes_launches": axes_family_launches(name),
                **summaries[name]}
               for name in counters]
    kernels[-1]["pp_ep_axes_shapes_held"] = report["pp_ep_kernels"][
        "summary"]
    enc_adamw = report["encoder_step"]["adamw"]
    kernels[-1]["encoder_path"] = {
        "trainer_launches": {m: n["fused_adamw"]
                             for m, n in enc_launches.items()},
        "step_launches_per_step": report["encoder_step"]["default"][
            "launches_per_step"]["fused_adamw"],
        **{k: enc_adamw[k] for k in ("params", "leaves", "max_abs_err", "tol",
                                     "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}}
    kernels.append({
        "name": "dtw", "route": "cuda", "source": "ste_gan_torch/csrc/dtw.cu",
        "kernel": "dtw_align_kernel",
        "replaces": "ste_gan_tpu/ops/dtw.py:36",
        "launches": enc_launches["mixed"]["dtw"],
        "launches_on": "the mixed encoder trainer run",
        "mixed_step_launches_per_step": report["encoder_step"]["mixed"][
            "launches_per_step"]["dtw"],
        "evaluate_launches": report["evaluate"]["encoder_silent"][
            "dtw_launches"],
        "dist_launches": {"encoder_two_ranks_voiced_rank0": dist_report[
            "trainers"]["encoder_rank0_launches"]["dtw"]},
        "tp_launches": {"train_encoder_1x2_rank0_voiced": tp_report[
            "encoder"]["rank0_launches"]["dtw"]},
        "tp_shapes_held": None,
        "pp_ep_axes_launches": axes_family_launches("dtw"),
        **dtw_summary})
    kernels.append({
        "name": "filtfilt", "route": "cuda", "source": "ste_gan_torch/csrc/iir.cu",
        "kernel": "filtfilt_kernel",
        "replaces": "ste_gan_tpu/etl/emg_dsp.py:33",
        "launches": report["prep"]["filtfilt_launches"],
        "launches_on": "the [prep] run (clean_audio, then prep_data)",
        "dist_launches": {},
        "tp_launches": {},
        "tp_shapes_held": None,
        "pp_ep_axes_launches": axes_family_launches("filtfilt"),
        **iir_summary})
    report["kernels"] = kernels
    report["laps_s"] = laps
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
