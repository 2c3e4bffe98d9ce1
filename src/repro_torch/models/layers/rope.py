"""Rotary position embeddings (half-split RoPE, float32 angles) and
Qwen2-VL's M-RoPE, as the JAX package's `models/layers/rope.py`.

M-RoPE splits the head dim's frequency bands into sections, each
rotated by one component of a (temporal, height, width) position.  A
text-only token carries the same position in all three components,
which is standard RoPE.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


def rope_angles(head_dim: int, theta: float, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., L] -> (cos, sin) of shape [..., L, head_dim/2]."""
    freqs = _freqs(head_dim // 2, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(head_dim: int, theta: float, positions: torch.Tensor,
                 sections: Sequence[int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE: positions [3, ..., L] (t / h / w components), sections
    summing to head_dim/2 -> (cos, sin) of shape [..., L, head_dim/2].
    Band j takes the position component of the section it lies in."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {half}")
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=positions.device),
        torch.tensor(list(sections), device=positions.device))
    pos_band = torch.movedim(positions, 0, -1)[..., sec_id]
    ang = pos_band.to(torch.float32) * _freqs(half, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def make_positions(batch: int, seq: int,
                   offset: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """[batch, seq] positions 0..seq-1, plus offset[b] on row b."""
    pos = torch.arange(seq, device=device)[None].expand(batch, seq)
    if offset is not None:
        pos = pos + offset.to(pos.device)[:, None]
    return pos


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., L, H, D]; cos/sin broadcastable to [..., L, 1, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
