"""mamba2-780m [ssm] — pure Mamba2 (SSD), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060]
Counterpart of `repro.configs.mamba2_780m`.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        tie_embeddings=True,
    )
)
