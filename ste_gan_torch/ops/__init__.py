"""Convolution, framing and optimizer ops of the port, and the hand-written
Hopper kernels behind them (``grouped_conv``, ``fused_adamw``, ``dtw``, and
``iir``, the zero-phase filter cascades of the corpus preparation)."""
