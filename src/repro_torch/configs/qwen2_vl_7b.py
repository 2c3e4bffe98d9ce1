"""Qwen2-VL-7B backbone: 28L dense, d=3584, 28H (GQA kv=4), d_ff=18944,
vocab 152064, M-RoPE (sections 16/24/24 over head_dim/2=64).  The vision
tower is a STUB — input_specs() provides per-position patch-embedding
deltas and 3-component (t,h,w) positions.  [arXiv:2409.12191]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)
