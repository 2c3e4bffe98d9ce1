"""Sentinels, a checkpoint ring and rollback for the fused driver.

`core.faults` makes the solver lose things (stale marginals, skipped
nodes, poisoned rows); this module makes it notice and recover on the
device, with no host read inside the fused chunk.

Each iteration `_guarded_update_impl` runs the driver's exact
accept/reject update (`sgp._accept_update_impl`, so a guarded fault-free
run is bit for bit the unguarded one) and then checks the post-accept
carry against four sentinels:

  1 nonfinite_cost    the carried cost went NaN / Inf
  2 nonfinite_phi     a φ entry is not finite (where `corrupt_p` poison
                      lands: the candidate's cost was measured before
                      the poison, so the accept rule cannot catch it)
  3 mass_drift        a simplex row's mass drifted more than `mass_eps`
                      from 1 (result rows may also be exactly empty)
  4 cost_explosion    the carried cost exceeds `explode_factor` times the
                      least of a trailing window of accepted costs
                      (inert under adaptive SGP, whose costs never rise)

On a trip the carry rolls back to the newest valid slot of a checkpoint
ring (φ, flows, cost, σ, written every `checkpoint_every` iterations
that ran clean), σ backs off ×`sigma_backoff` from the larger of the
current and the checkpoint's, and a retry budget (`max_retries`)
latches `stopped` when recovery keeps failing, restoring the checkpoint
even on the dying trip.  A sparse checkpoint that fails its health check
is repaired by `network.sanitize_phi_sparse` first.  All of it is
selects on device tensors: ring slots are picked by device scalars
(`index_select` / `index_copy_`), never by a host read, so the fused
driver's CUDA graph captures it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed

from .network import Neighbors, PhiSparse, sanitize_phi_sparse
from .sgp import _accept_update_impl, _f32, _fields


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Sentinel thresholds and the recovery policy."""
    mass_eps: float = 1e-3        # simplex row mass drift tolerance
    explode_factor: float = 10.0  # trip when cost > factor * window min
    window: int = 8               # trailing accepted-cost window length
    checkpoint_every: int = 8     # ring write cadence (iterations)
    ring: int = 4                 # checkpoint slots
    max_retries: int = 8          # rollbacks before latching stopped
    sigma_backoff: float = 4.0    # σ multiplier applied on rollback


@dataclasses.dataclass
class GuardEvent:
    """One sentinel trip, rendered on the host from the fused history."""
    it: int                       # the driver iteration
    sentinel: str                 # a SENTINEL_NAMES value
    action: str                   # "rollback" | "stop"
    cost: float                   # the iteration's candidate cost
    restored_cost: Optional[float] = None  # checkpoint cost (rollbacks)


SENTINEL_NAMES = {1: "nonfinite_cost", 2: "nonfinite_phi",
                  3: "mass_drift", 4: "cost_explosion"}


@dataclasses.dataclass(frozen=True)
class GuardState:
    """The guard carry, device tensors: the checkpoint ring ([R]-stacked
    φ and flows and their costs and σ), the trailing accepted-cost
    window and the trip and retry counts (int32 scalars)."""
    ckpt_phi: object              # [R]-stacked Phi | PhiSparse
    ckpt_fl: object               # [R]-stacked FlowsCarry
    ckpt_cost: torch.Tensor       # [R] float32 (inf: never written)
    ckpt_sigma: torch.Tensor      # [R] float32
    valid: torch.Tensor           # [R] bool
    ptr: torch.Tensor             # next ring slot to write
    window: torch.Tensor          # [W] float32 accepted costs (inf pad)
    wptr: torch.Tensor            # next window slot
    retries: torch.Tensor         # rollbacks consumed
    n_trips: torch.Tensor         # sentinel trips


def _stack_ring(x, R: int):
    """[R]-stacked zeros of a dataclass of tensors, slot 0 holding `x`."""
    out = []
    for t in _fields(x):
        ring = torch.zeros((R,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)
        ring[0] = t
        out.append(ring)
    return type(x)(*out)


def _i32(v, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int32, device=device)


def init_guard_state(phi, fl, T0, cfg: GuardConfig) -> GuardState:
    """The guard carry anchored at the entry iterate: ring slot 0 holds
    (φ, flows, T⁰, σ = 1), the guaranteed good rollback target, and the
    window starts [T⁰, inf, ...]."""
    R, W = cfg.ring, cfg.window
    dev = phi.data.device
    T0 = torch.as_tensor(T0, dtype=torch.float32, device=dev)
    ckpt_cost = torch.full((R,), float("inf"), dtype=torch.float32,
                           device=dev)
    ckpt_cost[0] = T0
    window = torch.full((W,), float("inf"), dtype=torch.float32,
                        device=dev)
    window[0] = T0
    valid = torch.zeros((R,), dtype=torch.bool, device=dev)
    valid[0] = True
    return GuardState(
        ckpt_phi=_stack_ring(phi, R), ckpt_fl=_stack_ring(fl, R),
        ckpt_cost=ckpt_cost,
        ckpt_sigma=torch.ones((R,), dtype=torch.float32, device=dev),
        valid=valid, ptr=_i32(1 % R if R > 1 else 0, dev), window=window,
        wptr=_i32(1 % W if W > 1 else 0, dev), retries=_i32(0, dev),
        n_trips=_i32(0, dev))


def _tree_finite(x) -> torch.Tensor:
    out = None
    for t in _fields(x):
        flag = torch.isfinite(t).all()
        out = flag if out is None else out & flag
    return out


def _mass_err(phi) -> torch.Tensor:
    """The worst simplex-row mass drift of φ: data rows must sum to 1,
    result rows to 1 or exactly 0.  NaN rows propagate into the max and
    fail the `<= eps` compare."""
    if isinstance(phi, PhiSparse):
        dsum = phi.data.sum(-1) + phi.local[..., 0]
    else:
        dsum = phi.data.sum(-1)
    rsum = phi.result.sum(-1)
    derr = torch.abs(dsum - 1.0).max()
    rerr = torch.minimum(torch.abs(rsum - 1.0), torch.abs(rsum)).max()
    return torch.maximum(derr, rerr)


def _phi_healthy(phi, eps: float) -> torch.Tensor:
    return _tree_finite(phi) & ~(_mass_err(phi) > eps)


def _ring_slot(ring, idx: torch.Tensor):
    """Slot `idx` (a device scalar) of a ring: a tensor, or a dataclass of
    tensors, picked by `index_select` (a copy)."""
    if torch.is_tensor(ring):
        return ring.index_select(0, idx.view(1))[0]
    return type(ring)(*(_ring_slot(t, idx) for t in _fields(ring)))


def _ring_write(ring, val, ptr: torch.Tensor, write: torch.Tensor) -> None:
    """Slot `ptr` of a ring ← `val` where `write`, in place."""
    if torch.is_tensor(ring):
        old = ring.index_select(0, ptr.view(1))[0]
        ring.index_copy_(0, ptr.view(1), torch.where(write, val, old)[None])
        return
    for r, v in zip(_fields(ring), _fields(val)):
        _ring_write(r, v, ptr, write)


def _guarded_update_impl(phi_new, fl_new, cost_new, phi, fl, sigma, prev,
                         n_costs, n_rej, stopped, tol, gs: GuardState,
                         nbrs: Optional[Neighbors] = None,
                         adaptive: bool = True,
                         cfg: GuardConfig = GuardConfig(), do_ckpt=False,
                         mesh=None):
    """One guarded driver iteration: `_accept_update_impl`, then the
    sentinels, rollback and checkpoint as selects.  Like it, it writes φ
    and the flows into `phi` and `fl` (the rollback target is the ring,
    never the pre-accept φ); the ring is written in place too.
    `do_ckpt` (a bool, or a bool device scalar the fused driver writes
    before each replay) says whether this iteration may write the ring.

    Under `mesh` (a `distributed.TaskMesh`: φ, the flows and the ring
    hold this rank's task shard) the φ sentinels and the checkpoint's
    health are or-reduced over the ranks (one all-reduce of three
    flags), so every rank trips and restores alike.

    Returns (sigma, prev, n_costs, n_rej, stopped, take, live, gs, code,
    rolled, ckpt_cost): the accept update's outputs, the new GuardState
    (its ring tensors those of `gs`), the iteration's sentinel (0:
    clean), whether the carry was restored, and the restored cost."""
    dev = cost_new.device
    R, W = cfg.ring, cfg.window
    sigma_pre, n_costs_pre, stopped_pre = sigma, n_costs, stopped
    window_pre, wptr_pre = gs.window, gs.wptr

    sigma_a, prev_a, n_costs_a, n_rej_a, stopped_a, take, live = \
        _accept_update_impl(phi_new, fl_new, cost_new, phi, fl, sigma,
                            prev, n_costs, n_rej, stopped, tol, adaptive)

    # sentinels on the post-accept carry, the most specific selected last
    cost_bad = ~torch.isfinite(prev_a)
    phi_bad = ~_tree_finite(phi)
    mass_bad = _mass_err(phi) > cfg.mass_eps
    explode = prev_a > _f32(cfg.explode_factor, dev) * window_pre.min()

    # the rollback target: the newest ring slot
    idx = ((gs.ptr + (R - 1)) % R).long()
    ck_valid = _ring_slot(gs.valid, idx)
    ck_cost = _ring_slot(gs.ckpt_cost, idx)
    ck_sigma = _ring_slot(gs.ckpt_sigma, idx)
    ck_phi = _ring_slot(gs.ckpt_phi, idx)
    ck_fl = _ring_slot(gs.ckpt_fl, idx)
    repair = isinstance(ck_phi, PhiSparse) and nbrs is not None
    if repair:
        ck_sick = ~_phi_healthy(ck_phi, cfg.mass_eps)
    if mesh is not None:
        flags = torch.stack([phi_bad, mass_bad,
                             ck_sick if repair else phi_bad]).to(torch.int32)
        mesh.all_reduce_(flags, torch.distributed.ReduceOp.MAX)
        phi_bad, mass_bad, ck_sick = (flags > 0).unbind()
    code = torch.zeros((), dtype=torch.int32, device=dev)
    for flag, c in ((explode, 4), (mass_bad, 3), (phi_bad, 2),
                    (cost_bad, 1)):
        code = torch.where(flag, c, code)
    trip = live & (code > 0)
    if repair:
        # a slot written before a later trip noticed its poison: repair it
        ck_ok = ~ck_sick & torch.isfinite(ck_cost)
        clean = sanitize_phi_sparse(ck_phi, nbrs)
        ck_phi = PhiSparse(*(torch.where(ck_ok, a, b) for a, b in
                             zip(_fields(ck_phi), _fields(clean))))

    restore = trip & ck_valid
    exhausted = trip & (gs.retries >= cfg.max_retries)
    die = trip & (~ck_valid | exhausted)
    for d, s in zip(_fields(phi) + _fields(fl),
                    _fields(ck_phi) + _fields(ck_fl)):
        torch.where(restore, s, d, out=d)
    prev_out = torch.where(restore, ck_cost, prev_a)
    sigma_out = torch.where(
        restore,
        torch.maximum(sigma_pre, ck_sigma) * _f32(cfg.sigma_backoff, dev),
        sigma_a)
    n_costs_out = torch.where(restore, n_costs_pre, n_costs_a)
    take2 = take & ~trip        # a rolled-back accept never reaches costs
    stopped_out = torch.where(restore, stopped_pre, stopped_a) | die

    # the trailing accepted-cost window; a restore re-anchors it at the
    # checkpoint's cost, or the retried steps would trip at once
    slots = torch.arange(W, device=dev)
    window_out = torch.where(take2 & (slots == wptr_pre % W), prev_a,
                             window_pre)
    wptr_out = torch.where(take2, wptr_pre + 1, wptr_pre)
    window_out = torch.where(
        restore, torch.where(slots == 0, ck_cost, float("inf")), window_out)
    wptr_out = torch.where(restore, 1 % W if W > 1 else 0, wptr_out)

    # the periodic checkpoint write (clean live iterations only)
    ptr = gs.ptr
    if do_ckpt is not False:
        write = live & (code == 0)
        if do_ckpt is not True:
            write = write & do_ckpt
        p = ptr.long()
        _ring_write(gs.ckpt_phi, phi, p, write)
        _ring_write(gs.ckpt_fl, fl, p, write)
        _ring_write(gs.ckpt_cost, prev_out, p, write)
        _ring_write(gs.ckpt_sigma, sigma_out, p, write)
        _ring_write(gs.valid, torch.ones((), dtype=torch.bool, device=dev),
                    p, write)
        ptr = torch.where(write, (ptr + 1) % R, ptr)

    gs_out = dataclasses.replace(
        gs, ptr=ptr, window=window_out, wptr=wptr_out,
        retries=gs.retries + restore.to(torch.int32),
        n_trips=gs.n_trips + trip.to(torch.int32))
    code_out = torch.where(trip, code, 0)
    # a dying trip still restores the checkpoint but renders as a stop
    return (sigma_out, prev_out, n_costs_out, n_rej_a, stopped_out, take2,
            live, gs_out, code_out, restore & ~die, ck_cost)
