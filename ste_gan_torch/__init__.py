"""STE-GAN in PyTorch for an NVIDIA H100: speech features -> 800 Hz EMG.

The port of the JAX package ``ste_gan_tpu`` (the reference, which stays as it
is). Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas is a CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc`` at
first use and loaded with ``ctypes`` (``ops/build.py``).

The port imports ``torch``, ``numpy`` and ``yaml`` and nothing of JAX or of
``ste_gan_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the kernel or raises.
"""
from ste_gan_torch import constants  # noqa: F401

__version__ = "0.1.0"
