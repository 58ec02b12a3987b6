"""The dense MLP, gated or not (``repro.models.mlp.mlp_apply``).

The Mixture-of-Experts layer (``moe_apply``) comes with the MoE family
(ROADMAP "Next", MoE).
"""

from __future__ import annotations

from repro_torch.models.layers import ACTIVATIONS


def mlp_apply(p, x, activation: str, gated: bool):
    """x [..., D] -> [..., D]; p holds w1 [D, F], w2 [F, D], w3 [D, F]
    when gated, and optional biases b1 [F], b2 [D]."""
    act = ACTIVATIONS[activation]
    h = x @ p["w1"]
    if "b1" in p:
        h = h + p["b1"]
    h = act(h)
    if gated:
        h = h * (x @ p["w3"])
    out = h @ p["w2"]
    if "b2" in p:
        out = out + p["b2"]
    return out
