"""Jamba-v0.1 52B: 32L hybrid (attention:mamba 1:7, attention at slot 3
of each 8-layer block), MoE 16e top-2 every other layer, d=4096,
32H (GQA kv=8), d_ff=14336, vocab 65536.  [arXiv:2403.19887]

TPU adaptation: Jamba's Mamba-1 blocks are realized with the Mamba-2/SSD
dual form (chunked scan maps onto the MXU; see DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, d_ff_expert=14336, n_experts=16, top_k=2,
    moe_period=2, moe_offset=1, attn_period=8, attn_offset=3,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    vocab=65536, rope_theta=1e6,
)
