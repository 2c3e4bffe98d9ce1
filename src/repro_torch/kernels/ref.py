"""Plain PyTorch versions of the port's kernels.

These are the oracles the Hopper kernels are held against, and the path
`kernels.ops` takes for tensors on the CPU.  They mirror the JAX
package's `kernels/ref.py` and `core/sgp.py:project_rows`:

* `fold_reduce` fixes the slot-axis reduction ORDER (pow2 zero-pad,
  `abs`, butterfly halving), which is what makes the padded [V, Dmax]
  and degree-bucketed [Vb, Db] tilings agree bitwise.
* `edge_rounds_ref` / `edge_rounds_bucketed_ref` iterate
  x <- combine(b, reduce_e w·(x[nbr] + shift)) to the exact fixed point
  (`fixed_point`, early exit on no change, `max_rounds` guard) and
  return the round count.  They compute in float32 and cast once at the
  end to the promoted type of (w, b), exactly as the kernels do.
* `simplex_project_ref` solves the Eq. 15 QP rows by bisection on the
  simplex dual in hoisted slope-intercept form with the bracket
  fixed-point early exit.
* `flash_attention_ref` / `decode_attention_ref` are the two attention
  kernels' function: scores in float32, softmax probabilities kept in
  float32 and normalised at the end, one cast of the output to the
  input dtype, as in the Pallas kernels (the JAX package's references
  round the probabilities to the input dtype before the product with v;
  at float32 the two agree to rounding).
* `ssd_scan_ref` is the SSD scan kernel's function in the chunked form
  that the model path computes (`models/layers/ssd.py:ssd_chunked`,
  float32, y cast to x's dtype), with the final state.  The JAX
  package's `ssd_scan_ref` is the sequential form; the two agree to
  float32 rounding.
* `moe_gmm_ref` is the grouped expert matmul of the MoE layer: float32
  sums over D, one cast to x's dtype, as the Pallas kernel and the JAX
  package's `moe_gmm_ref`, with the outputs of the experts that
  `active` leaves out set to zero.
"""
from __future__ import annotations

import torch

BIG = 1e12
SNAP_TOL = 1e-12
NEG_INF = -1e30


def fold_reduce(msg: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Reduce the last axis by butterfly fold-halving over its width
    zero-padded to the next power of two.

    The pairing is width-stable: for two power-of-two widths P' <= P
    with the live lanes in the first P' slots, folding from P collapses
    the exact-zero tail onto the live lanes and reproduces the fold over
    P' bit for bit.  Messages are nonnegative by the edge_rounds
    contract, so `abs` changes no value; it only keeps -0.0 partials out.
    """
    D = msg.shape[-1]
    P = 1 if D <= 1 else 1 << (D - 1).bit_length()
    if P != D:
        msg = torch.nn.functional.pad(msg, (0, P - D))
    msg = msg.abs()
    while P > 1:
        P //= 2
        lo, hi = msg[..., :P], msg[..., P:]
        msg = lo + hi if reduce == "sum" else torch.maximum(lo, hi)
    return msg[..., 0]


def fixed_point(step, x0: torch.Tensor, max_rounds: int):
    """Iterate x <- step(x) until it stops changing or `max_rounds` is
    hit.  Returns (x, rounds), rounds counting the applications of step."""
    x_prev, x, k = x0, step(x0), 1
    while k < max_rounds and bool(torch.any(x != x_prev)):
        x_prev, x, k = x, step(x), k + 1
    return x, k


def _combine(reduce: str):
    if reduce == "sum":
        return lambda b, red: b + red
    if reduce == "max":
        return torch.maximum
    raise ValueError(f"unknown reduce {reduce!r}")


def edge_rounds_ref(w_sp, inject, nbr, mask, reduce: str = "sum",
                    shift: float = 0.0, max_rounds: int | None = None):
    """w_sp [S, V, Dmax], inject [S, V], nbr/mask [V, Dmax] ->
    (x [S, V] in the promoted dtype, rounds)."""
    combine = _combine(reduce)
    V = nbr.shape[0]
    max_rounds = V if max_rounds is None else max_rounds
    out_dtype = torch.promote_types(w_sp.dtype, inject.dtype)
    w = torch.where(mask, w_sp.float(), 0.0)
    b = inject.float()
    nbr = nbr.long()

    def step(x):
        return combine(b, fold_reduce(w * (x[:, nbr] + shift), reduce))

    x, k = fixed_point(step, b, max_rounds)
    return x.to(out_dtype), k


def edge_rounds_bucketed_ref(w_sp, inject, buckets, reduce: str = "sum",
                             shift: float = 0.0,
                             max_rounds: int | None = None):
    """`edge_rounds_ref` over degree-bucketed tiles (`kernels.edge_rounds.
    EdgeBuckets`): each [Vb, Db] bucket gathers and reduces only its own
    lanes; the per-bucket rows land at their nodes.  Bitwise equal to the
    padded version on every row."""
    combine = _combine(reduce)
    V = buckets.nodes.shape[0]
    max_rounds = V if max_rounds is None else max_rounds
    out_dtype = torch.promote_types(w_sp.dtype, inject.dtype)
    b = inject.float()
    w = w_sp.float()
    rows, lanes = buckets.row_off.tolist(), buckets.lane_off.tolist()
    tiles = []
    for k, Db in enumerate(buckets.widths):
        r, l = slice(rows[k], rows[k + 1]), slice(lanes[k], lanes[k + 1])

        def tile(t):
            return t[l].long().reshape(-1, Db)

        wt = torch.where(tile(buckets.mask) > 0,
                         w[:, tile(buckets.wsrc), tile(buckets.wslot)], 0.0)
        tiles.append((buckets.nodes[r].long(), tile(buckets.nbr), wt))

    def step(x):
        y = torch.empty_like(x)
        for nodes, nbr_b, wt in tiles:
            red = fold_reduce(wt * (x[:, nbr_b] + shift), reduce)
            y[:, nodes] = combine(b[:, nodes], red)
        return y

    x, k = fixed_point(step, b, max_rounds)
    return x.to(out_dtype), k


def dual_setup(phi, delta, M, permitted):
    """Slope-intercept form of the Eq. 15 dual: (q, w, d, λ_lo, λ_hi),
    with (q, w, d) = (-BIG, 0, BIG) on blocked coordinates."""
    Msafe = torch.where(permitted, torch.clamp_min(M, 1e-12), 1.0)
    phi0 = torch.where(permitted, phi, 0.0)
    d = torch.where(permitted, delta, BIG)
    lam_lo = torch.where(permitted, -d - 2.0 * Msafe * (1.0 - phi0),
                         BIG).amin(-1, keepdim=True)
    lam_hi = torch.where(permitted, -d + 2.0 * Msafe * phi0,
                         -BIG).amax(-1, keepdim=True)
    w = torch.where(permitted, 1.0 / (2.0 * Msafe), 0.0)
    q = torch.where(permitted, phi0 - d / (2.0 * Msafe), -BIG)
    return q, w, d, lam_lo, lam_hi


def simplex_project_ref(phi, delta, M, permitted, n_iter: int = 60):
    """Eq. 15 rows [R, K]:  min_v δ·(v-φ) + (v-φ)ᵀ diag(M) (v-φ)  over
    the simplex with v[~permitted] = 0, by bisection on the dual λ of
    v_j(λ) = max(q_j - λ w_j, 0),  q = φ - d/(2M),  w = 1/(2M).

    Values under SNAP_TOL snap to 0 and the row is renormalised; a row
    that snaps to all zero falls back to the one-hot at the first
    argmin of δ; a fully blocked row comes back all zero."""
    q, w, d, lo, hi = dual_setup(phi, delta, M, permitted)

    def v_of(lam):
        return torch.clamp_min(q - lam * w, 0.0)

    # a bracket that stops moving stays put, so exiting once no row's
    # bracket moved equals running all n_iter halvings
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        up = v_of(mid).sum(-1, keepdim=True) > 1.0
        lo2 = torch.where(up, mid, lo)
        hi2 = torch.where(up, hi, mid)
        changed = bool(torch.any(lo2 != lo) | torch.any(hi2 != hi))
        lo, hi = lo2, hi2
        if not changed:
            break
    v = v_of(0.5 * (lo + hi))
    v = torch.where(v > SNAP_TOL, v, 0.0)
    s = v.sum(-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(
        d.argmin(-1), d.shape[-1]).to(phi.dtype)
    v = torch.where(s > 0.0, v / torch.clamp_min(s, 1e-30), onehot)
    return torch.where(permitted.any(-1, keepdim=True), v, 0.0)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """exp(s - rowmax) @ v / rowsum, all in float32."""
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (p @ v) / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """q [B, H, Sq, hd]; k, v [B, KV, Sk, hd] -> [B, H, Sq, hd] in q's
    dtype (KV head of query head h: h // (H / KV)).  Not causal, Sk is
    any length (cross attention: the softmax over all Sk keys); causal
    needs Sk = Sq."""
    B, H, S, hd = q.shape
    if causal and k.shape[2] != S:
        raise ValueError(f"causal attention needs as many keys as "
                         f"queries, got {k.shape[2]} for {S}")
    g = H // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * hd ** -0.5
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    return _softmax_pv(s, vf).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """q [B, KV, G, hd]; caches [B, S, KV, hd] (the engine's layout);
    lengths [B] -> [B, KV, G, hd] in q's dtype.  Positions >= lengths[b]
    are masked with NEG_INF."""
    B, S, KV, hd = k_cache.shape
    kf = k_cache.float().transpose(1, 2)                 # [B, KV, S, hd]
    vf = v_cache.float().transpose(1, 2)
    s = (q.float() @ kf.transpose(-1, -2)) * hd ** -0.5  # [B, KV, G, S]
    valid = (torch.arange(S, device=q.device)[None]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None], s, NEG_INF)
    return _softmax_pv(s, vf).to(q.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm, init_state=None, chunk: int = 256):
    """x [B, L, H, P], dt [B, L, H], A [H], Bm / Cm [B, L, N] ->
    (y [B, L, H, P] in x's dtype, final state [B, H, N, P] float32):
    `ssd_chunked` at chunk min(chunk, L), which asserts L % chunk == 0."""
    from ..models.layers.ssd import ssd_chunked
    return ssd_chunked(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1]),
                       init_state=init_state)


def moe_gmm_ref(x, w, active=None) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F]: float32 sums, cast to x's
    dtype; zero for the experts that `active` ([E]; None keeps every
    expert) leaves out."""
    out = torch.bmm(x.float(), w.float())
    if active is not None:
        out = torch.where(active.bool()[:, None, None], out, 0.0)
    return out.to(x.dtype)
