"""PyTorch/CUDA port of the FNO surrogate for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names and never imports it (or JAX). Every entry point runs on ``cuda``
unless the caller passes ``device="cpu"``; with no card and no device given
it raises instead of falling back to the CPU.
"""
