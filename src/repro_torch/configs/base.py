"""Architecture configs of the model zoo: one frozen dataclass drives
model construction and the roofline math.

A copy of ``repro.configs.base`` (plain Python, no jax): ``--model
<id>`` resolves through the registry (``get_config``); each
architecture lives in its own module citing its source. The port
registers an architecture once its family runs here (all of the JAX
package's: the dense ``qwen1.5-4b``, ``nemotron-4-15b``, ``granite-20b``
and ``qwen2.5-32b``, the VLM ``chameleon-34b``, the MoE
``mixtral-8x7b`` and ``qwen3-moe-235b-a22b``, the SSM ``mamba2-370m``,
the hybrid ``zamba2-2.7b`` and the audio ``whisper-medium``); the
mesh-sharding and dry-run fields are kept so that a config means the
same on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad vocab to a shardable multiple (logits over padding ids are
    never produced as labels). Kept import-free: configs must not import
    model code (model modules import configs)."""
    return ((vocab + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    activation: str = "silu"        # silu | gelu | relu2
    gated_mlp: bool = True
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 512
    moe_capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): one shared attention+MLP block applied every
    # ``attn_every`` SSM layers (tied weights)
    attn_every: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    n_frames: int = 1500            # encoder source positions (stub frontend)
    # attention
    window: Optional[int] = None    # sliding-window attention (SWA)
    long_context_window: int = 4096  # window used for long_500k dense variant
    decode_buffer: int = 256        # replicated decode write-buffer slots
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    # gradient-accumulation microbatches for train_4k on the production
    # mesh — sized per arch so the remat-saved per-layer stacks fit
    # 16 GiB/chip (EXPERIMENTS.md §Dry-run)
    train_microbatches: int = 4
    # Adam moment storage dtype; "bfloat16" halves optimizer HBM (used by
    # qwen3-moe-235b to fit one pod — EXPERIMENTS.md §Perf HC2)
    adam_moment_dtype: str = "float32"
    # citation
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Archs running long_500k natively (sub-quadratic / O(1) state or
        native SWA); dense archs run it via the SWA variant."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        emb = self.padded_vocab * d * 2  # embed + lm_head (untied)
        per_layer = 0
        if self.family == "ssm":
            per_layer = self._ssm_block_params()
        elif self.family == "hybrid":
            per_layer = self._ssm_block_params()
            n_shared = L // max(self.attn_every, 1)
            shared = (self._attn_params() + 3 * d * f + 2 * d)
            return emb + L * per_layer + shared + n_shared * 0 + 2 * d
        else:
            per_layer += self._attn_params()
            if self.n_experts:
                per_layer += d * self.n_experts  # router
                mult = 3 if self.gated_mlp else 2
                per_layer += self.n_experts * mult * d * f
            else:
                mult = 3 if self.gated_mlp else 2
                per_layer += mult * d * f
            per_layer += 2 * d  # norms
        total = emb + L * per_layer + d
        if self.encoder_layers:
            enc_layer = self._attn_params() + 2 * d * f + 2 * d
            total += self.encoder_layers * enc_layer
            total += L * (self._attn_params() + d)  # decoder cross-attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.n_experts:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        mult = 3 if self.gated_mlp else 2
        dense_like = self.param_count() - L * self.n_experts * mult * d * f
        return dense_like + L * self.top_k * mult * d * f

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim * 2 + d * self.kv_dim * 2

    def _ssm_block_params(self) -> int:
        d = self.d_model
        di = self.d_inner
        proj_in = d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
        return proj_in + di * d + (di + 2 * self.ssm_state) * self.ssm_conv + 3 * self.ssm_heads + di + 2 * d


ARCHS: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced variant of the same family for CPU smoke tests
    (2 layers, d_model <= 512, <= 4 experts)."""
    small: dict = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 1024),
        name=cfg.name + "-smoke",
    )
    if cfg.n_experts:
        small["n_experts"] = min(cfg.n_experts, 4)
        small["top_k"] = min(cfg.top_k, 2)
        small["moe_group_size"] = 64
        # capacity = group: no token ever dropped, so prefill/decode are
        # bitwise-consistent with the full forward in the smoke tests
        small["moe_capacity_factor"] = (small["n_experts"]
                                        / max(small["top_k"], 1))
    if cfg.ssm_state:
        small["ssm_state"] = min(cfg.ssm_state, 32)
        small["ssm_head_dim"] = 32
        small["ssm_chunk"] = 16
    if cfg.attn_every:
        small["attn_every"] = 1
        small["n_kv_heads"] = small["n_heads"]
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
        small["n_frames"] = 16
    if cfg.window is not None:
        small["window"] = 64
    small["decode_buffer"] = 8      # exercise flush_recent in smoke tests
    if cfg.n_kv_heads == cfg.n_heads:  # MHA archs stay MHA
        small["n_kv_heads"] = small["n_heads"]
    small["dtype"] = "float32"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
