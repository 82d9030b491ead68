"""Model configurations for the LM serving stack (counterpart of
`repro.configs.base`).

Every served architecture is a frozen `ModelConfig`.  The port keeps
the fields that shape the dense and SSM models and their serving path;
the reference's dry-run shapes (`ShapeSpec`) and parallelism knobs
(sharding profile, remat, microbatching, scanned layers) have no
counterpart on one card in a no-grad path, and the MoE, hybrid,
encoder-decoder and vision fields come with those families.  Importing
a config touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # tokens; None = full attention
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # norm / act
    norm_eps: float = 1e-5
    use_layernorm: bool = False  # False -> RMSNorm
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP)

    # numerics
    dtype: str = "bfloat16"
    attn_chunk: int = 1024  # online-softmax KV block for long sequences
    attn_full_max: int = 8192  # materialised attention up to this S

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 128)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim


_REGISTRY: Dict[str, ModelConfig] = {}

# The reference's other architectures, by family: their serving path
# comes with a later slice of the port.
LATER_SLICE = {
    "llama3-405b": "dense", "qwen3-4b": "dense", "stablelm-1.6b": "dense",
    "mixtral-8x7b": "moe", "qwen2-moe-a2.7b": "moe", "zamba2-7b": "hybrid",
    "whisper-medium": "audio", "phi-3-vision-4.2b": "vlm",
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    """The registered config of `arch_id`; raises NotImplementedError for
    an architecture whose port waits for a later slice, KeyError for
    an unknown one."""
    if arch_id not in _REGISTRY:
        from repro_torch import configs  # noqa: F401  (registers every ported arch)
    if arch_id in _REGISTRY:
        return _REGISTRY[arch_id]
    if arch_id in LATER_SLICE:
        raise NotImplementedError(
            f"{arch_id} ({LATER_SLICE[arch_id]}) is not ported yet: the port serves "
            f"{sorted(_REGISTRY)}; the other architectures come with a later slice "
            "(ROADMAP Slice G)")
    raise KeyError(f"unknown architecture {arch_id!r}")


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (the reference's
    widths for the dense and SSM families)."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        attn_chunk=32,
    )
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    return dataclasses.replace(cfg, **kw)
