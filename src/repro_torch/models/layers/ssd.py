"""State-Space Duality (Mamba2) selective scan (PyTorch port of the JAX
package's `models/layers/ssd.py`).

  ssd_sequential  — the O(L) recurrence, one step a token; the oracle.
  ssd_chunked     — the SSD block algorithm: within a chunk the causal
                    quadratic term, between chunks the state carried in
                    order.  The plain version of the Hopper kernel K6
                    (`kernels.ref.ssd_scan_ref` calls it).
  ssd_decode_step — one token's state update (the decode path).

All three compute in float32 and cast y back to x's dtype.

Shapes (one B/C group):
  x  [B, L, H, P]   inputs per head
  dt [B, L, H]      discretization steps (post-softplus)
  A  [H]            negative decay rates
  Bm [B, L, N]      input projection (shared across heads)
  Cm [B, L, N]      output projection
returns y [B, L, H, P] and the final state [B, H, N, P] (float32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _zero_state(x, N, init_state):
    B, _, H, P = x.shape
    if init_state is None:
        return torch.zeros((B, H, N, P), dtype=torch.float32,
                           device=x.device)
    return init_state.float()


def ssd_sequential(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    state = _zero_state(x, Bm.shape[-1], init_state)
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    A = A.float()
    ys = []
    for t in range(x.shape[1]):
        dA = torch.exp(dtf[:, t] * A[None])                    # [B, H]
        dBx = torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], Bf[:, t], xf[:, t])
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 256,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:                    # the JAX package's assert, kept
        raise AssertionError((L, chunk))  # under python -O too
    nc = L // chunk

    xc = x.float().reshape(B, nc, chunk, H, P)
    dtc = dt.float().reshape(B, nc, chunk, H)
    Bc = Bm.float().reshape(B, nc, chunk, N)
    Cc = Cm.float().reshape(B, nc, chunk, N)

    dA = dtc * A.float()[None, None, None]           # [B,nc,Q,H] (<= 0)
    cum = torch.cumsum(dA, dim=2)                    # within-chunk cumsum
    total = cum[:, :, -1]                            # [B,nc,H]

    # intra-chunk (quadratic, causal): decay(i, j) = exp(cum_i - cum_j)
    # for i >= j, the mask applied BEFORE the exp (the masked entries'
    # positive differences would overflow)
    diff = cum[:, :, :, None] - cum[:, :, None]      # [B,nc,Q,Q,H]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    diff = torch.where(causal[None, None, ..., None], diff, NEG_INF)
    Ldec = torch.exp(diff)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # [B,nc,Q,Q]
    w = scores[..., None] * Ldec * dtc[:, :, None]    # [B,nc,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk-local final states
    decay_to_end = torch.exp(total[:, :, None] - cum)  # [B,nc,Q,H]
    S_loc = torch.einsum("bcqh,bcqn,bcqhp->bchnp",
                         decay_to_end * dtc, Bc, xc)   # [B,nc,H,N,P]

    # inter-chunk recurrence, in order
    S = _zero_state(x, N, init_state)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * torch.exp(total[:, c])[..., None, None] + S_loc[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)             # [B,nc,H,N,P]

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc, S_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, L, H, P)
    return y.to(x.dtype), S


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token state update.  state [B, H, N, P]; x_t [B, H, P],
    dt_t [B, H], B_t / C_t [B, N] -> (y [B, H, P] in x_t's dtype,
    state float32)."""
    state = state.float()
    dtf = dt_t.float()
    dA = torch.exp(dtf * A.float()[None])
    dBx = torch.einsum("bh,bn,bhp->bhnp", dtf, B_t.float(), x_t.float())
    state = state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), state)
    return y.to(x_t.dtype), state
