"""Where the reference's convolutions and matrix products round.

``Precision(dtype)`` casts both operands of every convolution and product
to ``dtype`` and computes there (f32 for the reference itself, bf16 for a
control). ``fp8=True`` first rounds each operand to float8 e4m3 with one
scale per tensor (the largest magnitude maps to 448), forward only, the
gradient passing straight through: the control for a bf16 program.
``tf32`` is cuDNN's TF32 switch inside :meth:`active`, and cuBLAS's too
unless ``products`` says otherwise. ``products``, where given, is the
precision of the matrix products alone (the encoder's linear layers and
attention), so a control can round them apart from the convolutions.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch

E4M3_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float32
    fp8: bool = False
    tf32: bool = False
    products: Optional["Precision"] = None

    def mm(self) -> "Precision":
        """The precision of the matrix products."""
        return self.products or self

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t.to(self.dtype)
        t32 = t.float()
        scale = t32.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        rounded = (t32 / scale).to(torch.float8_e4m3fn).float() * scale
        return (t32 + (rounded - t32).detach()).to(self.dtype)

    @contextlib.contextmanager
    def active(self):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.mm().tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


F32 = Precision()
