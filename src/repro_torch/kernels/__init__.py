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
    lstm — an LSTM layer over T time steps (one step is T = 1) and its
           backward over the same T steps, W workers per launch
           (replaces repro/kernels/lstm/kernel.py)
    evl  — the Extreme Value Loss with its reduction and its dL/du in
           one launch (replaces repro/kernels/evl/kernel.py)
    attention — flash attention with GQA and its masks
           (replaces repro/kernels/attention/kernel.py)
    ssd  — the Mamba2 SSD chunk scan from a zero state
           (replaces repro/kernels/ssd/kernel.py)
"""
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.evl.ops import evl_loss
from repro_torch.kernels.lstm.ops import lstm_cell, lstm_layer

__all__ = ["evl_loss", "flash_attention", "lstm_cell", "lstm_layer"]
