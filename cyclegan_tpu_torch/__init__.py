"""PyTorch/CUDA port of the CycleGAN serving path for one NVIDIA H100.

Mirrors the module layout of the JAX package so each counterpart is easy
to find, and imports nothing of it. Public functions take and return
NHWC tensors, as the JAX package does; internally the convolutions run
on ``channels_last`` tensors. Every entry point takes a ``device``
argument that defaults to ``"cuda"``; the CPU is used only when a caller
asks for it, and there every kernel site runs its plain PyTorch version.
"""
