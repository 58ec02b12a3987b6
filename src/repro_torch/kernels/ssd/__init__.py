"""The Mamba2 SSD chunk scan (replaces ``repro/kernels/ssd/kernel.py``)."""
