"""Mamba2-130M: 24L attention-free SSD, d=768 (d_inner 1536, 24 ssm
heads x 64), ssm_state=128, vocab 50280.  [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, attn_period=-1,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
)
