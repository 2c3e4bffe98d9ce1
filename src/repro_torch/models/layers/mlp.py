"""SwiGLU feed-forward block (dense MLP).

Weights are the port's `[d, f]` / `[f, d]` matrices, already in the
compute dtype (the model casts them once at load)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..module import ParamSpec


def mlp_specs(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wg": ParamSpec((d, f), ("embed", "mlp"), dt),
        "wu": ParamSpec((d, f), ("embed", "mlp"), dt),
        "wd": ParamSpec((f, d), ("mlp", "embed"), dt),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """x [B, L, d] -> [B, L, d]; p holds wg, wu [d, f] and wd [f, d]."""
    h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]
