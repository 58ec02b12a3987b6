"""GQA attention of the model zoo (``repro.models.attention``).

``blocked_attention`` is the attention every zoo forward runs. In the
JAX package it is a pure-JAX online-softmax twin of the Pallas kernel;
here it is the routed flash attention itself
(``kernels.dispatch.flash_attention``): on the card the hand-written
CUDA kernel, on the CPU its plain version. Two differences by design:
the kernel chooses its own tiles, so the JAX function's ``q_block`` /
``kv_block`` have no counterpart; and the kernel multiplies the
probabilities with v in fp32, where ``blocked_attention`` first rounds
them to v's dtype (bf16 on the card's path), as the TPU kernel does not.

The naive oracle of the JAX package (``reference_attention``) is the
kernel's plain version here, ``kernels.attention.ref.attention_ref``.
``decode_attention`` comes with the decode path (ROADMAP "Next").
"""

from __future__ import annotations

from repro_torch.kernels import dispatch

# q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D], Hq % Hkv == 0 (GQA); causal,
# a sliding ``window`` (keys in [pos - window + 1, pos]) and ``q_offset``
# (the absolute position of q[0]) as in the JAX function; [B, Sq, Hq, D]
# in q's dtype
blocked_attention = dispatch.flash_attention
