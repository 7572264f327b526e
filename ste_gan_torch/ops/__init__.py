"""Convolution, framing and optimizer ops of the port, and the hand-written
Hopper kernels behind them (``grouped_conv``, ``fused_adamw``, ``dtw``, and
``iir``, the zero-phase filter cascades of the corpus preparation)."""


def kernel_launches() -> dict:
    """The hand kernels' launch counts in this process (each wrapper's
    ``launches``): what a rank or a CLI reports of its own run."""
    from ste_gan_torch.ops import dtw, fused_adamw, grouped_conv, iir

    return {"grouped_conv_fwd": grouped_conv.conv_fwd.launches,
            "grouped_conv_dx": grouped_conv.conv_dx.launches,
            "grouped_conv_dw": grouped_conv.conv_dw.launches,
            "fused_adamw": fused_adamw.fused_adamw_.launches,
            "dtw": dtw.dtw_alignment_batched.launches,
            "filtfilt": iir.filtfilt_cascade.launches}
