"""PyTorch + CUDA port of ``repro``, for one NVIDIA H100.

The layout mirrors ``repro`` module for module. Plain tensor code is
PyTorch; each TPU kernel of ``repro.kernels`` becomes a CUDA C++ kernel
written for Hopper (``repro_torch.kernels``). The package imports
torch, numpy and the standard library only: never jax, and nothing of
``repro``. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``.
"""
