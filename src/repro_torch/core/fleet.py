"""Batched fleet solver: B scenarios on one topology, one replay an
iteration.

Many concurrent solver instances (one per cell, cluster or time window)
share a physical topology and differ in their tasks: rates `r`,
destinations `dest`, result ratios `a`, compute weights `w`.  Solved one
at a time, each pays its own launches and its own host reads.  This
driver keeps each lane's solo driver state (`sgp.init_run_state`) and
advances every lane with the solo fused driver's own iteration (one
`sgp.FusedStream` a lane, its `_iterate`), so each lane's costs and φ
are bit for bit its solo `run_chunk(driver="fused")`.

On the card one iteration of all B lanes (their iterations in turn,
each with its own K1 and K3 launches) is captured into one CUDA graph,
replayed once an iteration; on the CPU the lanes step in turn.
`n_dispatches` counts the dispatches: one an iteration, whatever B is
(the reference's vmapped driver counts two, a propose and an accept).
The chunk's one host read comes at its end, for every lane at once.

Warm starts: `FleetCache` memoizes converged strategies keyed by the
adjacency and a hash of every per-lane field (`fleet_cache_key`), so a
recurring task pattern re-enters at its converged φ instead of the cold
shortest-path tree.  The keys hash the port's own tensors (int64 `dest`
and `task_type`, where the reference holds int32), so they need not
equal the reference's; they separate and join the same scenarios.

Like the reference, the fleet runs the sparse padded engine with
adaptive scaling only; a lane carries the solo driver's `stopped` flag
and freezes as its fused chunk would.  The port picks each kernel by its
tensors' device, so `engine_impl` and `proj_impl` must be None.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import sgp
from .costs import Cost
from .network import (CECNetwork, Neighbors, PhiSparse, build_neighbors,
                      spt_phi_sparse)


# ----------------------------------------------------------- warm cache
def _host(x) -> np.ndarray:
    return np.ascontiguousarray(
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def fleet_cache_key(net: CECNetwork, active=None) -> tuple:
    """(adjacency bytes, task-pattern sha1) of one scenario.

    The hash covers every field that tells lanes on one topology apart
    (dest, task_type, a, r, w and the cost parameters and families), so
    equal keys are the same problem and a converged φ transfers.  A task
    pool's [S_cap] `active` mask is part of the problem too: inert slots
    keep stale fields, so two pool states can agree on every hashed
    field and differ in which slots are live."""
    h = hashlib.sha1()
    for x in (net.dest, net.task_type, net.a, net.r, net.w,
              net.link_cost.params, net.comp_cost.params):
        arr = _host(x)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(net.link_cost.family.encode())
    h.update(net.comp_cost.family.encode())
    if active is None:
        h.update(b"|fixed-S")
    else:
        act = _host(active).astype(bool)
        h.update(b"|pool:" + str(act.shape[0]).encode())
        h.update(act.tobytes())
    return (_host(net.adj).astype(bool).tobytes(), h.hexdigest())


class FleetCache:
    """LRU of converged strategies, keyed by `fleet_cache_key`.  It keeps
    host copies (no device memory pinned for scenarios that may never
    recur); `get` puts them back on the network's device."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, net: CECNetwork, active=None) -> Optional[PhiSparse]:
        key = fleet_cache_key(net, active=active)
        hit = self._d.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return PhiSparse(*(torch.as_tensor(x, device=net.device)
                           for x in hit))

    def put(self, net: CECNetwork, phi: PhiSparse, active=None) -> None:
        key = fleet_cache_key(net, active=active)
        self._d[key] = tuple(_host(x).copy()
                             for x in (phi.data, phi.local, phi.result))
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)


# ------------------------------------------------------------ fleet state
def _check_fleet(nets: Sequence[CECNetwork]) -> None:
    """Raise unless every scenario has the same adjacency and cost
    families: the fleet shares one `Neighbors` tile set and one step."""
    if not nets:
        raise ValueError("empty fleet")
    adj0 = nets[0].adj
    for b, net in enumerate(nets[1:], start=1):
        if not torch.equal(net.adj, adj0):
            raise ValueError(
                f"fleet lane {b} has a different adjacency: the batched "
                "driver shares one topology (and one Neighbors tile set) "
                "across every lane; solve topology variants as separate "
                "fleets")
        for fam0, fam in ((nets[0].link_cost.family, net.link_cost.family),
                          (nets[0].comp_cost.family, net.comp_cost.family)):
            if fam != fam0:
                raise ValueError(
                    f"fleet lane {b} mixes cost families ({fam!r} vs "
                    f"{fam0!r}): the step's cost functions are shared")


def stack_fleet(nets: Sequence[CECNetwork]) -> CECNetwork:
    """The B one-topology scenarios stacked field by field into one
    lane-batched network.  Raises unless every scenario has the same
    adjacency and cost families."""
    _check_fleet(nets)
    return CECNetwork(
        adj=torch.stack([n.adj for n in nets]),
        link_cost=Cost(nets[0].link_cost.family,
                       torch.stack([n.link_cost.params for n in nets])),
        comp_cost=Cost(nets[0].comp_cost.family,
                       torch.stack([n.comp_cost.params for n in nets])),
        **{f: torch.stack([getattr(n, f) for n in nets])
           for f in ("dest", "r", "a", "w", "task_type")})


@dataclasses.dataclass
class FleetState:
    """A running fleet: each lane's network and its solo driver state
    (`sgp.RunState`, sharing one `Neighbors` tile set).  `costs` holds
    each lane's accepted costs on the host ([T⁰, accepted...], the solo
    `RunState.costs`), extended at each chunk's one read.
    `n_dispatches` counts the fleet's dispatches since init (one an
    iteration, whatever B is); `graph_stats` is what the last chunk
    measured of its CUDA graph (None on the CPU)."""
    nets: List[CECNetwork]
    lanes: List[sgp.RunState]
    nbrs: Neighbors
    warm: List[bool]                 # lane b's φ⁰ came from the cache
    it: int = 0
    n_dispatches: int = 0
    graph_stats: Optional[dict] = None

    @property
    def B(self) -> int:
        return len(self.lanes)

    @property
    def costs(self) -> List[List[float]]:
        return [lane.costs for lane in self.lanes]

    def lane_net(self, b: int) -> CECNetwork:
        return self.nets[b]

    def lane_phi(self, b: int) -> PhiSparse:
        """Lane b's iterate, in the solo driver's layout."""
        return self.lanes[b].phi


def _no_impl(engine_impl, proj_impl=None) -> None:
    if engine_impl is not None or proj_impl is not None:
        raise ValueError("engine_impl and proj_impl must be None: the port "
                         "picks each kernel by its tensors' device")


def init_fleet_state(nets: Sequence[CECNetwork], phi0s=None,
                     min_scale: float = 0.05,
                     nbrs: Optional[Neighbors] = None,
                     engine_impl: Optional[str] = None,
                     cache: Optional[FleetCache] = None) -> FleetState:
    """`sgp.init_run_state` for every lane: φ⁰ is the caller's
    `phi0s[b]` (a dense φ is converted to slots), else a `cache` hit for
    the lane's task pattern, else the cold shortest-path tree."""
    _no_impl(engine_impl)
    _check_fleet(nets)
    if nbrs is None:
        nbrs = build_neighbors(nets[0].adj)
    warm = [False] * len(nets)
    lanes = []
    for b, net in enumerate(nets):
        p = phi0s[b] if phi0s is not None else None
        if p is None and cache is not None:
            p = cache.get(net)
            warm[b] = p is not None
        if p is None:
            p = spt_phi_sparse(net, nbrs)
        lanes.append(sgp.init_run_state(net, p, min_scale=min_scale,
                                        method="sparse", nbrs=nbrs))
    return FleetState(nets=list(nets), lanes=lanes, nbrs=nbrs, warm=warm)


def run_fleet_chunk(state: FleetState, n_iters: int, variant: str = "sgp",
                    tol: float = 0.0, use_blocking: bool = True,
                    scaling: str = "adaptive", kappa: float = 0.0,
                    proj_impl: Optional[str] = None) -> FleetState:
    """Advance every lane `n_iters` iterations, one dispatch an
    iteration (one CUDA graph replay on the card), then one host read
    that folds each lane's history into its state.  Updates `state` in
    place and returns it.

    The solo fused chunk's options less what a fleet cannot share:
    paper-scaling refreshes, Theorem-2 masks, faults and guards are the
    solo driver's."""
    _no_impl(None, proj_impl)
    if scaling != "adaptive":
        raise NotImplementedError(
            "fleet lanes carry per-lane sigma only; scaling='paper' "
            "consts refreshes are a solo-driver feature")
    if n_iters <= 0:
        return state
    streams = [sgp.FusedStream(net, lane, variant=variant, tol=tol,
                               use_blocking=use_blocking, scaling=scaling,
                               kappa=kappa)
               for net, lane in zip(state.nets, state.lanes)]
    rec = torch.zeros((state.B, 3), dtype=torch.float32,
                      device=state.nets[0].device)

    def iterate():
        for s in streams:
            s._iterate()
        torch.stack([s._rec for s in streams], out=rec)

    runner = sgp._Graphed(iterate, rec.device)
    sgp._advance_streams(streams, n_iters, runner, rec)
    runner.graph = None
    state.n_dispatches += n_iters
    state.graph_stats = dict(runner.stats) if runner.stats["graph"] \
        else None
    sgp._finish_streams(streams)        # the chunk's one host read
    for lane in state.lanes:
        lane.graph_stats = state.graph_stats
    state.it += n_iters
    return state


def run_fleet(nets: Sequence[CECNetwork], n_iters: int = 200, phi0s=None,
              min_scale: float = 0.05, tol: float = 0.0,
              nbrs: Optional[Neighbors] = None,
              engine_impl: Optional[str] = None,
              cache: Optional[FleetCache] = None, **chunk_opts):
    """Solve a whole fleet: init, one chunk, one read.

    Returns (phis, history): each lane's `PhiSparse` (lane b bit for bit
    the solo `run(nets[b], ..., method="sparse")` under the same
    options) and {"costs" per lane, "warm" cache-hit flags,
    "n_dispatches", "stopped" per lane}.  A `cache` takes each lane's
    final strategy on the way out."""
    state = init_fleet_state(nets, phi0s=phi0s, min_scale=min_scale,
                             nbrs=nbrs, engine_impl=engine_impl,
                             cache=cache)
    run_fleet_chunk(state, n_iters, tol=tol, **chunk_opts)
    phis = [state.lane_phi(b) for b in range(state.B)]
    if cache is not None:
        for net, phi in zip(nets, phis):
            cache.put(net, phi)
    history = {"costs": [list(c) for c in state.costs],
               "warm": list(state.warm),
               "n_dispatches": state.n_dispatches,
               "stopped": [lane.stopped for lane in state.lanes]}
    return phis, history
