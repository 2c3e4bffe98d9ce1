"""Mixture-of-Experts FFN (PyTorch port of the JAX package's
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
* Dispatch and combine are the JAX layer's custom VJPs as
  `autograd.Function`s with the same backward arithmetic: dispatch
  gathers token rows into the expert slots and its backward gathers the
  slots' gradients back at (expert, position) and sums over K, not a
  scatter-add; combine gathers the slots at each token's (expert,
  position) and sums them weighted by the gate, its backward gathers
  the tokens' gradients into the slots.  `cfg.moe_ep_scatter` selects
  the JAX layer's expert-parallel variants (combine forward and
  dispatch backward as scatter-adds into token space), which compute
  the same values in another summation order.  The load EMAs, the
  router gap and the sort's ranks carry no gradient.
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


def _segsum_to_tokens(src, e_idx, p_idx, keep, w=None):
    """sum_e,c w_slot[g,e,c] * src[g,e,c,:] into token rows [G, Tg, D]:
    the reference's scatter-add into token space, taken from the token
    side.  Token t's kept assignment k (keep [G, Tg, K]) sits at slot
    (e_idx, p_idx) with weight w[g, t, k] (float32; None: 1).  Each
    token adds its kept slots one at a time in src's dtype, in the order
    the scatter-add visits them (slot order: ascending expert).  No
    atomics, so a call repeats bit for bit on the card."""
    K = e_idx.shape[2]
    rows = src[_groups(src)[:, None, None], e_idx, p_idx]    # [G, Tg, K, D]
    if w is not None:
        rows = rows * w[..., None].to(src.dtype)
    rows = torch.where(keep[..., None], rows, 0)
    order = torch.sort(e_idx, dim=-1, stable=True).indices
    rows = torch.take_along_dim(rows, order[..., None], dim=2)
    out = rows[:, :, 0]
    for k in range(1, K):
        out = out + rows[:, :, k]
    return out


def _groups(t):
    return torch.arange(t.shape[0], device=t.device)


class _Dispatch(torch.autograd.Function):
    """x [G, Tg, D] -> the expert slots [G, E, C, D]: slot (e, c) holds
    token slot_tok[g, e, c] (zero where `valid` is 0).  Backward: the
    slots' gradients gathered at each assignment's (e_idx, p_idx) and
    summed over K where kept; with `ep`, a scatter-add of the slots into
    token space instead (the JAX layer's `_dispatch_ep`)."""

    @staticmethod
    def forward(ctx, x, slot_tok, valid, e_idx, p_idx, keep, ep):
        gi = _groups(x)[:, None, None]
        Tg = x.shape[1]
        ctx.save_for_backward(slot_tok, valid, e_idx, p_idx, keep)
        ctx.ep, ctx.Tg, ctx.dtype = ep, Tg, x.dtype
        return x[gi, slot_tok.clamp_max(Tg - 1)] * valid[..., None].to(
            x.dtype)

    @staticmethod
    def backward(ctx, d_buf):
        slot_tok, valid, e_idx, p_idx, keep = ctx.saved_tensors
        if ctx.ep:
            dx = _segsum_to_tokens(d_buf, e_idx, p_idx, keep)
        else:
            d_buf = d_buf * valid[..., None].to(d_buf.dtype)
            dslots = d_buf[_groups(d_buf)[:, None, None], e_idx, p_idx]
            dx = (dslots * keep[..., None].to(d_buf.dtype)).sum(2)
        return dx.to(ctx.dtype), None, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """The expert outputs [G, E, C, D] and the gate weights w [G, Tg, K]
    -> y [G, Tg, D] = Σ_k w[g,t,k]·out[g, e_idx, p_idx]; with `ep` the
    JAX layer's `_combine_ep` (a scatter-add of the weighted slots into
    token space, here `_segsum_to_tokens`).  Backward: d_out the tokens'
    gradients gathered into the slots times their weight; d_w each
    assignment's dot of dy with its slot (with `ep` taken in slot space,
    as the reference does, and gathered back at (e_idx, p_idx) where
    the reference scatters it: each kept (t, k) owns one slot)."""

    @staticmethod
    def forward(ctx, out, w, slot_tok, slot_k, valid, e_idx, p_idx, keep,
                ep):
        gi = _groups(out)[:, None, None]
        ctx.save_for_backward(out, w, slot_tok, slot_k, valid, e_idx, p_idx,
                              keep)
        ctx.ep = ep
        if ep:
            return _segsum_to_tokens(out, e_idx, p_idx, keep, w.float())
        slots = out[gi, e_idx, p_idx]                      # [G, Tg, K, D]
        return torch.einsum("gtk,gtkd->gtd", w.to(out.dtype), slots)

    @staticmethod
    def backward(ctx, dy):
        out, w, slot_tok, slot_k, valid, e_idx, p_idx, keep = \
            ctx.saved_tensors
        Tg = w.shape[1]
        gi = _groups(out)[:, None, None]
        tok = slot_tok.clamp_max(Tg - 1)
        dy_slots = dy[gi, tok]                             # [G, E, C, D]
        w_slots = w[gi, tok, slot_k]                       # [G, E, C]
        d_out = dy_slots * (w_slots.float() * valid)[..., None].to(dy.dtype)
        if ctx.ep:
            dw_slot = (dy_slots * out).sum(-1).float() * valid
            d_w = torch.where(keep, dw_slot[gi, e_idx, p_idx], 0.0)
        else:
            slots = out[gi, e_idx, p_idx]
            d_w = torch.einsum("gtd,gtkd->gtk", dy, slots)
        return (d_out.to(out.dtype), d_w.to(w.dtype), None, None, None,
                None, None, None, None)


def moe(p, state: dict, x: torch.Tensor, cfg, impl: Optional[str] = None):
    """x [B, L, D] -> (y [B, L, D], new_state, metrics).  p holds router
    [D, E] (float32) and wg, wu [E, D, f], wd [E, f, D] (compute dtype);
    state {"load_ema": [E] float32}.  Metrics: moe_imbalance (max/mean
    expert load), moe_drop_frac (share of assignments dropped) and
    router_gap, the smallest gap between a token's K-th and (K+1)-th
    selection logits over max(1, |K-th|) (inf when K = E).
    Differentiable in x and p (the training loss)."""
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
    sel = logits.detach()
    if cfg.router_bias == "congestion":
        st = moe_bridge.CongestionState(
            state["load_ema"], torch.zeros((), dtype=torch.int32,
                                           device=dev))
        cap = torch.full((E,), T * cfg.top_k / E * 1.3, dtype=torch.float32,
                         device=dev)
        bias = moe_bridge.congestion_bias(st, cap, eta=cfg.router_bias_eta)
        sel = sel + bias[None, None, :]
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
    # and its top-k slot
    g_idx = torch.arange(G, device=dev)[:, None, None].expand(G, Tg, K)
    tok = torch.arange(Tg, device=dev)[None, :, None].expand(G, Tg, K)
    at = (g_idx, top_idx, torch.where(keep, pos, C))
    slot_tok = torch.full((G, E, C + 1), Tg, dtype=torch.long, device=dev)
    slot_tok[at] = tok
    slot_tok = slot_tok[..., :C]
    slot_k = torch.zeros((G, E, C + 1), dtype=torch.long, device=dev)
    slot_k[at] = torch.arange(K, device=dev)[None, None, :].expand(G, Tg, K)
    slot_k = slot_k[..., :C]
    valid = (slot_tok < Tg).float()
    p_idx = torch.where(keep, pos, 0)
    ep = bool(cfg.moe_ep_scatter)

    # dispatch, the expert SwiGLU through K7, combine
    buf = _Dispatch.apply(xt.to(cd), slot_tok, valid, top_idx, p_idx, keep,
                          ep)                              # [G, E, C, D]
    buf = buf.transpose(0, 1).reshape(E, G * C, D)
    active = counts > 0
    g = ops.moe_gmm(buf, p["wg"], impl=impl, active=active)
    u = ops.moe_gmm(buf, p["wu"], impl=impl, active=active)
    out = ops.moe_gmm(F.silu(g) * u, p["wd"], impl=impl,
                      active=active)                       # [E, G·C, D]
    out = out.reshape(E, G, C, D).transpose(0, 1)          # [G, E, C, D]
    w = (gate * keep).to(cd)
    y = _Combine.apply(out, w, slot_tok, slot_k, valid, top_idx, p_idx, keep,
                       ep)

    new_state = {"load_ema": 0.9 * state["load_ema"] + 0.1 * counts}
    metrics = {"moe_imbalance": moe_bridge.load_imbalance(counts),
               "moe_drop_frac": 1.0 - keep.float().mean(),
               "router_gap": gap}
    return y.reshape(B, L, D), new_state, metrics
