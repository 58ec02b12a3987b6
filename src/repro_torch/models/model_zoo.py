"""``build_model(cfg)``: one functional handle over the zoo's
architectures (``repro.models.model_zoo``).

``init``, ``forward``, ``prefill``, ``decode_step`` and ``init_cache``
run for every family: dense, vlm, moe, ssm, hybrid and audio
(Qwen1.5-4B, Nemotron-4-15B, Granite-20B, Qwen2.5-32B; Chameleon-34B;
Mixtral-8x7B, Qwen3-MoE-235B-A22B; Mamba2-370M; Zamba2-2.7B;
Whisper-medium, whose ``forward`` and ``prefill`` take ``frames``);
``forward`` returns the MoE load-balance loss beside the logits (0 for
the other families);
``loss`` is ``transformer.lm_loss`` (on the card the ``ssm`` and
``hybrid`` families' raises while their SSD backward is not ported).
``transformer.flush_recent`` folds a full-mode cache's recent slots
into main.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable            # (generator) -> params
    forward: Callable         # (params, tokens, frames=None) -> (logits, aux)
    loss: Callable            # (params, tokens, frames=None) -> scalar
    prefill: Callable         # (params, tokens, frames=None) -> (logits, cache)
    decode_step: Callable     # (params, token, cache) -> (logits, cache)
    init_cache: Callable      # (batch, max_len, device="cuda") -> cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator: tfm.init_lm(cfg, generator),
        forward=lambda p, t, frames=None: tfm.lm_forward(cfg, p, t, frames),
        loss=lambda p, t, frames=None: tfm.lm_loss(cfg, p, t, frames),
        prefill=lambda p, t, frames=None: tfm.lm_prefill(cfg, p, t, frames),
        decode_step=lambda p, tok, c: tfm.lm_decode_step(cfg, p, tok, c),
        init_cache=lambda batch, max_len, device="cuda": tfm.init_cache(
            cfg, batch, max_len, device),
    )
