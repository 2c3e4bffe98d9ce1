"""Congestion-aware MoE routing: the paper's δ-marginals inside the model
(PyTorch port of the JAX package's `core/moe_bridge.py`).

Expert dispatch is a one-hop instance of the offloading problem: the
experts are compute units with a convex congestion cost C_e(G_e) (the
queueing family of `core/costs.py`), the dispatch fabric is a set of
congestible links D_e(F_e), and the combine traffic returns once per
token (a = 1).  Theorem 1 sends flow only to experts of minimal marginal

    δ_e = D'_e(F_e) + w_e · C'_e(G_e) + a · D'_e(F_e),

which the router realises as a logit bias -η·δ_e before its top-k
choice, with the expert loads G_e tracked by an EMA across calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .costs import FAMILIES


@dataclasses.dataclass(frozen=True)
class CongestionState:
    """Per-MoE-layer router state, carried across steps."""
    load_ema: torch.Tensor    # [E] EMA of tokens per expert
    step: torch.Tensor        # scalar int32


def init_state(num_experts: int, dtype=torch.float32,
               device=None) -> CongestionState:
    return CongestionState(
        load_ema=torch.zeros((num_experts,), dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def congestion_bias(state: CongestionState, capacity: torch.Tensor, *,
                    eta: float = 1e-2, a: float = 1.0,
                    w: Union[torch.Tensor, float] = 1.0,
                    link_capacity: Optional[torch.Tensor] = None,
                    family: str = "queue") -> torch.Tensor:
    """-η·δ_e per expert (Eq. 13 on the one-hop MoE graph).  capacity
    [E] is the expert compute capacity in tokens a step; link_capacity
    [E] the dispatch links' (default: the expert capacity)."""
    fam = FAMILIES[family]
    G = state.load_ema
    Cp = fam.d1(G, capacity)
    link_cap = capacity if link_capacity is None else link_capacity
    Dp = fam.d1(G, link_cap)
    delta = Dp + w * Cp + a * Dp
    return -eta * delta


def update_state(state: CongestionState, counts: torch.Tensor,
                 decay: float = 0.99) -> CongestionState:
    """EMA update from this step's tokens-per-expert counts [E]."""
    ema = decay * state.load_ema + (1.0 - decay) * counts.to(
        state.load_ema.dtype)
    return CongestionState(load_ema=ema, step=state.step + 1)


def expert_counts(top_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Tokens per expert [E] float32 from a [..., k] top-k index array."""
    return torch.bincount(top_idx.reshape(-1).long(),
                          minlength=num_experts).float()


def load_imbalance(counts: torch.Tensor) -> torch.Tensor:
    """max / mean load: 1.0 is perfectly balanced."""
    return counts.max() / torch.clamp_min(counts.mean(), 1e-9)
