"""RMSNorm, computed in float32 and cast back (as the JAX package's
`models/layers/norms.py`)."""
from __future__ import annotations

import torch

from ..module import ParamSpec


def rmsnorm_spec(dim: int, name_axis: str = "embed") -> ParamSpec:
    return ParamSpec((dim,), (name_axis,), init="ones")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    return (y * scale.float()).to(x.dtype)
