"""Readings of the kanana encoder cell's program spans and counters for its
kernel rooflines and its routing.

The device time by span and the counters come from
``lfm2_phases.span_device_s`` (one traced pass with the program's spans
on, each device operation charged to the innermost program span open on
the thread that launched it, autograd's thread included); the load
imbalance from ``phases.untraced``. A program without the spans or
counters gives None, and the metrics that read them are left out of the
line.

The work each roofline counts, per step at the cell's shapes (``N``
frames, ``W`` windows of ``T`` frames, ``H`` heads, widths ``R`` latent,
``Q = nope + rope`` query/key, ``V`` value, 2 bytes a value):

* ``mla_roofline``, over the device time under ``enc/mla/attention``
  (the latent norm, and RoPE with the attention core, both directions),
  the larger of two least times:

  - operations: the causal core's products over the ``T (T + 1) / 2``
    pairs a window and head: forward ``q k^T`` (``Q``) and ``p v``
    (``V``), backward ``dp = do v^T`` and ``dv = p^T do`` (``V``), ``dq
    = ds k`` and ``dk = ds^T q`` (``Q``); ``2 W H T (T + 1) / 2 (3 Q + 3
    V)`` a layer, at the bf16 peak;
  - bytes: each span input read and each output written once, a frame:
    the norm's ``c`` in and out forward, ``dc_n`` and ``c`` in and ``dc``
    out backward (``5 R``); the core's ``q`` (``H Q``), ``kv`` (``H (nope
    + V)``) and ``k_pe`` (``rope``) in and ``o`` (``H V``) out forward,
    ``do``, ``q``, ``kv``, ``k_pe`` and ``o`` in and ``dq``, ``dkv``,
    ``dk_pe`` out backward; at the HBM rate;

* ``moe_expert_roofline``: ``lfm2_phases``' count, 3 forward and 6
  backward grouped products of ``2 * picks * D * F`` over the sparse
  layers' picks (``moe/picks``), at the bf16 peak, over the device time
  under ``enc/moe/experts``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from portbench import lfm2_phases, peaks, phases

MLA_ATTENTION = phases.PROGRAM + "enc/mla/attention"


def _params(run) -> Dict:
    from portbench.drivers.enc_train_kanana import encoder_params

    return encoder_params(run.config)


def mla_work(p: Dict, windows: int, frames: int) -> Tuple[float, float]:
    """``(operations, bytes)`` of one step's ``enc/mla/attention`` work
    over every layer, for ``windows`` windows of ``frames`` frames."""
    h, r = p["num_attention_heads"], p["kv_lora_rank"]
    nope, rope, v = (p["qk_nope_head_dim"], p["qk_rope_head_dim"],
                     p["v_head_dim"])
    q = nope + rope
    pairs = frames * (frames + 1) / 2
    ops = 2.0 * windows * h * pairs * (3 * q + 3 * v)
    q_in, kv_in, o_out = h * q, h * (nope + v), h * v
    core = ((q_in + kv_in + rope + o_out)
            + (o_out + q_in + kv_in + rope + o_out)
            + (q_in + kv_in + rope))
    nbytes = 2.0 * windows * frames * (5 * r + core)
    layers = p["num_hidden_layers"]
    return layers * ops, layers * nbytes


def mla_roofline(run) -> Optional[float]:
    t = lfm2_phases.span_device_s(run)
    if t is None or not t["units"]:
        return None
    device_s = t["device_s"].get(MLA_ATTENTION, 0.0)
    if device_s <= 0:
        return None
    window = int(run.config["train"]["seq_len"]) // 2
    ops, nbytes = mla_work(_params(run), lfm2_phases.step_frames(run)
                           // window, window)
    least = max(ops / peaks.PEAK_OPS_PER_S["bf16"],
                nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * least * t["units"] / device_s


def moe_expert_roofline(run) -> Optional[float]:
    t = lfm2_phases.span_device_s(run)
    if t is None:
        return None
    device_s = t["device_s"].get(lfm2_phases.EXPERTS, 0.0)
    picks = t["counters"].get("moe/picks", (0.0, 0))[0]
    if device_s <= 0 or picks <= 0:
        return None
    p = _params(run)
    ops = (lfm2_phases.EXPERT_PRODUCTS * 2.0 * picks * p["hidden_size"]
           * p["moe_intermediate_size"])
    return 100.0 * ops / peaks.PEAK_OPS_PER_S["bf16"] / device_s


def load_imbalance(run) -> Optional[float]:
    """The most-loaded expert's picks over the mean load, over the sparse
    layers and the untraced stretch's steps: ``moe/max_load * E /
    moe/picks`` (1 is even)."""
    u = phases.untraced(run)
    if u is None:
        return None
    picks = u["counters"].get("moe/picks", (0.0, 0))[0]
    top = u["counters"].get("moe/max_load", (0.0, 0))[0]
    if picks <= 0:
        return None
    return top * _params(run)["n_routed_experts"] / picks
