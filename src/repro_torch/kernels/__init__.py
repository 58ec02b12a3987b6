"""Hand-written Hopper kernels of the port, one package per TPU kernel
of ``repro.kernels`` it replaces.

Each kernel package holds:
    csrc/*.cu — the CUDA C++ source, built with nvcc for sm_90a at first
                use (``build.py``) and bound with ctypes
    kernel.py — the binding: build, launch, launch counter
    ops.py    — the wrapper: checks, and the device route (CUDA tensor ->
                kernel, CPU tensor -> plain version)
    ref.py    — the plain PyTorch version

Kernels ported so far:
    lstm — one LSTM time step (replaces repro/kernels/lstm/kernel.py)
"""
