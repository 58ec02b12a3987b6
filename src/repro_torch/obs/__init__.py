"""Observability of the port's serving stack: per-request trace spans
(``trace``)."""

from repro_torch.obs.trace import Tracer

__all__ = ["Tracer"]
