"""qwen2.5-3b [dense] — GQA kv=2, QKV bias, tied embeddings.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
[hf:Qwen/Qwen2.5-3B family]  Counterpart of `repro.configs.qwen2_5_3b`.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen2.5-3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
)
