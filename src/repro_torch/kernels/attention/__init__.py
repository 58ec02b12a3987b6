"""Flash attention (replaces ``repro/kernels/attention/kernel.py``)."""
