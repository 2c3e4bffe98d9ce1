"""Whisper-base backbone: 6L encoder + 6L decoder, d=512, 8H (MHA),
d_ff=2048, vocab 51865.  Conv audio frontend is a STUB — input_specs()
provides precomputed frame embeddings [B, 1500, 512].  [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, n_enc_frames=1500,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865, rope_theta=1e4,
)
