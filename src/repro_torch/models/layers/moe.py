"""Mixture-of-Experts FFN, forward (PyTorch port of the JAX package's
`models/layers/moe.py`): top-k routing with the paper's congestion-aware
gate, group-local capacity-bounded dispatch, SwiGLU experts.

* The router's logits are float32 (x upcast, router kept float32);
  `router_bias="congestion"` adds -η·δ_e from `core.moe_bridge` at the
  layer's load EMA, with capacity T·K/E·1.3 for the call's own T tokens.
  The bias selects; the softmax of the unbiased logits weights.
* The top-k is a stable descending sort: among equal logits the lower
  expert comes first, as `lax.top_k` orders them.
* Each assignment's position in its expert is a cumsum over the K-major
  flattening [K·Tg, E], so every token's first choice is placed before
  any second choice; an assignment at position >= C is dropped.  Counts
  are taken before the drops.
* The three expert products go through `kernels.ops.moe_gmm` (K7): the
  Hopper kernel on the card, `moe_gmm_ref` on the CPU.  They are told
  which experts hold a row (`counts > 0`; an expert with no assignment
  has only zero rows, and silu(0)·0 = 0 in the down projection), so the
  kernel reads no weight of an empty expert: the same function.
* The new state is `0.9·load_ema + 0.1·counts`.

The custom VJPs of the JAX layer (training) come with ROADMAP P13d.
`cfg.moe_ep_scatter` selects a sharded lowering of the combine that
computes the same y; the port has one device and ignores it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core import moe_bridge
from ...kernels import ops
from ..module import ParamSpec


def moe_specs(cfg) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.param_dtype
    return {
        "router": ParamSpec((d, E), ("embed", "experts"), torch.float32),
        "wg": ParamSpec((E, d, f), ("experts", "embed", "mlp"), dt),
        "wu": ParamSpec((E, d, f), ("experts", "embed", "mlp"), dt),
        "wd": ParamSpec((E, f, d), ("experts", "mlp", "embed"), dt),
    }


def moe_state_specs(cfg) -> dict:
    """Mutable router state (the congestion EMA), threaded through calls."""
    return {"load_ema": ParamSpec((cfg.n_experts,), ("experts",),
                                  torch.float32, init="zeros")}


def _capacity(tokens_per_group: int, cfg) -> int:
    cap = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
              / cfg.n_experts)
    return max(4, min(cap, tokens_per_group))


def moe(p, state: dict, x: torch.Tensor, cfg, impl: Optional[str] = None):
    """x [B, L, D] -> (y [B, L, D], new_state, metrics).  p holds router
    [D, E] (float32) and wg, wu [E, D, f], wd [E, f, D] (compute dtype);
    state {"load_ema": [E] float32}.  Metrics: moe_imbalance (max/mean
    expert load), moe_drop_frac (share of assignments dropped) and
    router_gap, the smallest gap between a token's K-th and (K+1)-th
    selection logits over max(1, |K-th|) (inf when K = E)."""
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * L
    G = cfg.moe_groups if T % cfg.moe_groups == 0 else 1
    Tg = T // G
    C = _capacity(Tg, cfg)
    cd = cfg.compute_dtype
    dev = x.device
    xt = x.reshape(G, Tg, D)

    logits = xt.float() @ p["router"]                      # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    sel = logits
    if cfg.router_bias == "congestion":
        st = moe_bridge.CongestionState(
            state["load_ema"], torch.zeros((), dtype=torch.int32,
                                           device=dev))
        cap = torch.full((E,), T * cfg.top_k / E * 1.3, dtype=torch.float32,
                         device=dev)
        bias = moe_bridge.congestion_bias(st, cap, eta=cfg.router_bias_eta)
        sel = logits + bias[None, None, :]
    ranked, order = torch.sort(sel, dim=-1, descending=True, stable=True)
    top_idx = order[..., :K]                               # [G, Tg, K]
    if K < E:
        kth = ranked[..., K - 1]
        gap = ((kth - ranked[..., K]) / kth.abs().clamp_min(1.0)).min()
    else:
        gap = torch.full((), float("inf"), device=dev)
    gate = torch.gather(probs, -1, top_idx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # position of each assignment within its (group, expert), K-major
    onehot = F.one_hot(top_idx, E)                         # [G, Tg, K, E]
    flat = onehot.transpose(1, 2).reshape(G, K * Tg, E)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = torch.gather(pos_flat.reshape(G, K, Tg, E).transpose(1, 2), -1,
                       top_idx[..., None])[..., 0]         # [G, Tg, K]
    keep = pos < C
    counts = flat.sum(dim=(0, 1)).float()                  # [E], pre-drop

    # slot tables [G, E, C]: the token in each expert slot (Tg: empty)
    g_idx = torch.arange(G, device=dev)[:, None, None].expand(G, Tg, K)
    tok = torch.arange(Tg, device=dev)[None, :, None].expand(G, Tg, K)
    slot_tok = torch.full((G, E, C + 1), Tg, dtype=torch.long, device=dev)
    slot_tok[g_idx, top_idx, torch.where(keep, pos, C)] = tok
    slot_tok = slot_tok[..., :C]
    valid = (slot_tok < Tg).to(cd)

    # dispatch, the expert SwiGLU through K7, combine
    xc = xt.to(cd)
    buf = xc[torch.arange(G, device=dev)[:, None, None],
             slot_tok.clamp_max(Tg - 1)] * valid[..., None]  # [G, E, C, D]
    buf = buf.transpose(0, 1).reshape(E, G * C, D)
    active = counts > 0
    g = ops.moe_gmm(buf, p["wg"], impl=impl, active=active)
    u = ops.moe_gmm(buf, p["wu"], impl=impl, active=active)
    out = ops.moe_gmm(F.silu(g) * u, p["wd"], impl=impl,
                      active=active)                       # [E, G·C, D]
    out = out.reshape(E, G, C, D).transpose(0, 1)          # [G, E, C, D]
    slots = out[g_idx, top_idx, torch.where(keep, pos, 0)]  # [G, Tg, K, D]
    w = (gate * keep).to(cd)
    y = torch.einsum("gtk,gtkd->gtd", w, slots)

    new_state = {"load_ema": 0.9 * state["load_ema"] + 0.1 * counts}
    metrics = {"moe_imbalance": moe_bridge.load_imbalance(counts),
               "moe_drop_frac": 1.0 - keep.float().mean(),
               "router_gap": gap}
    return y.reshape(B, L, D), new_state, metrics
