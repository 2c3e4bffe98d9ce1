"""Rotary position embeddings (half-split RoPE, float32 angles), as the
JAX package's `models/layers/rope.py`.  M-RoPE comes with the VLM
slice."""
from __future__ import annotations

import torch


def rope_angles(head_dim: int, theta: float, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., L] -> (cos, sin) of shape [..., L, head_dim/2]."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., L, H, D]; cos/sin broadcastable to [..., L, 1, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
