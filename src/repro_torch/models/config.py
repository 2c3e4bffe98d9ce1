"""Model configuration shared by the 10 architectures (PyTorch port).

The same fields and defaults as the JAX package's `models/config.py`, so
configurations copy over verbatim; dtypes are torch dtypes.  Fields
that steer only the JAX package's TPU sharding and scan lowering
(`shard_rules`, `seq_shard_axis`, `scan_layers`, `remat`, the blocked
attention tiles) are kept and ignored by the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 0                 # dense FFN width (0 = no FFN sublayer)
    vocab: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1           # MoE FFN when i % period == offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_bias: str = "congestion"   # none | congestion (the paper's δ)
    router_bias_eta: float = 1.0
    # dispatch groups: tokens are split into groups with group-local
    # expert capacity (GShard-style).  Launchers set this to the DP
    # shard count so dispatch buffers/scatters stay shard-local.
    moe_groups: int = 1
    # EP wire optimization: combine-fwd / dispatch-bwd as scatter-adds
    # (per-shard pre-reduction over local experts; see layers/moe.py)
    moe_ep_scatter: bool = False
    # §Perf flags (hillclimb levers; default off = baseline behavior)
    pin_attn_heads: bool = False    # constrain q/k/v head sharding
    embed_tbl_shard: bool = False   # shard the embedding table on
                                    # d_model instead of vocab (untied)

    # hybrid (attention/mamba interleave); attn_period == 0 -> all attn,
    # attn_period < 0 -> no attention (pure SSM)
    attn_period: int = 0
    attn_offset: int = 0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # encoder-decoder
    n_enc_layers: int = 0
    n_enc_frames: int = 1500      # whisper-base 30 s of audio

    # misc
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = ()
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logits_soft_cap: float = 0.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    remat: str = "layer"          # none | layer
    scan_layers: bool = True
    # blocked-attention tile sizes + unroll (unroll=True is used by the
    # roofline "accounting" lowering: XLA's HloCostAnalysis counts while
    # bodies once, so loops must be unrolled for correct FLOP totals)
    attn_block_q: int = 512
    attn_block_k: int = 1024
    attn_unroll: bool = False
    # Megatron-style sequence sharding of the residual stream: the
    # per-layer remat carries shard their seq dim over this mesh axis
    # (XLA inserts all-gather/reduce-scatter at layer boundaries).
    # None = off (tests / single device); launchers set "model".
    seq_shard_axis: Any = None
    seq_shard_multiple: int = 16  # only applied when seq % this == 0
    # Logical->mesh rules applied as sharding constraints on the
    # per-layer parameter slices INSIDE the scan body.  Without this,
    # XLA hoists the FSDP all-gather of the whole stacked parameter
    # array out of the loop (un-sharding every layer at once).  Tuple of
    # (logical_axis, mesh_axis_or_tuple) pairs; None = off.
    shard_rules: Any = None

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def mixer_kind(self, i: int) -> str:
        if self.attn_period < 0:
            return "mamba"
        if self.attn_period == 0:
            return "attn"
        return "attn" if i % self.attn_period == self.attn_offset else "mamba"

    def ffn_kind(self, i: int) -> str:
        if self.n_experts > 0 and i % self.moe_period == self.moe_offset:
            return "moe"
        return "dense" if self.d_ff > 0 else "none"

    def layer_pattern(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) kind per layer."""
        return tuple((self.mixer_kind(i), self.ffn_kind(i))
                     for i in range(self.n_layers))

    def scan_period(self) -> int:
        """Smallest repeating period of the layer pattern."""
        pat = self.layer_pattern()
        n = len(pat)
        for p in range(1, n + 1):
            if n % p == 0 and all(pat[i] == pat[i % p] for i in range(n)):
                return p
        return n

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    period = cfg.scan_period()
    base = dict(
        n_layers=max(2 * period, period),
        d_model=64,
        n_heads=max(cfg.n_heads and 4, 0),
        n_kv_heads=max(min(cfg.n_kv_heads, 2), 0) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        d_ff_expert=64 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_enc_frames=24 if cfg.n_enc_layers else 1500,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else (),
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        cache_dtype=torch.float32,
        remat="none",
    )
    base.update(overrides)
    return cfg.replace(**base)
