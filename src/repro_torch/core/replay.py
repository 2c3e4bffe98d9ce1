"""Streaming churn replay on the sparse engine: the system's online mode.

A `ReplayEngine` owns a live edge-slot `PhiSparse` iterate and applies a
`ChurnSchedule` of events to it (rate churn, source and destination
re-draws, node failures and recoveries, link cuts, task arrivals and
departures; `core.events`), repairing the iterate on the device and
WARM-restarting the resumable driver (`sgp.run_chunk`) between events
instead of re-solving from the SPT φ⁰.

Same-graph events ("rate", "routing", "task": the adjacency, and so the
`Neighbors` tiles and the captured CUDA graph's shapes, are unchanged)
can skip the host entirely: `play(..., stream=True)` runs every maximal
run of them, warm gaps included, as one `sgp.FusedStream` whose
`rebaseline` folds each event into the carry, with a single host read
at the window's end.  Topology events break the stream and take the
event loop's `apply_event`.

What the port guarantees, as the reference does, on the port's own
trajectories:

* a zero-event replay is bit for bit `run(method="sparse")`;
* the fused stream is bit for bit the event loop on the canned
  schedules: costs, final φ, `EventRecord` segmentation, Theorem-2
  asynchronous replays included;
* after every event the iterate passes `check_invariants`;
* within each inter-event segment the accepted costs never rise.

The Theorem-2 generator: the engine takes a `torch.Generator` on the
network's device and never draws from it.  Segment k (k = 0 at
construction, one more at every event) draws its row masks from a
generator on the same device seeded with
`SeedSequence([rng.initial_seed(), k])` (`segment_seed`), in the event
loop and in the stream alike.  A fault plan's generator is derived the
same way from `fault_rng` (default seed 0) on a stream of its own,
`SeedSequence([fault_rng.initial_seed(), k, 1])`, so each segment draws
an independent fault stream and the stream stays the event loop bit for
bit.  The reference splits `jax.random` keys, which torch cannot
replay, so asynchronous and faulted replays agree with it only in
distribution (not tested).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .events import (ChurnSchedule, ChurnState, DestRedraw, TaskArrive,
                     TaskPool, RateSet, event_kind, upload)
from .network import (CECNetwork, Neighbors, PhiSparse, build_buckets,
                      build_neighbors, clear_task_slot, is_loop_free,
                      mask_inactive_slots, pad_phi_sparse,
                      refeasibilize_sparse, refeasibilize_sparse_samegraph,
                      seed_task_slot, sparse_to_phi, spt_phi_sparse,
                      spt_result_slots)
from . import distributed as dist
from .sgp import FusedStream, init_run_state, run_chunk, run_opt_keys


# ------------------------------------------------------------ invariants
def check_feasible(phi_sp: PhiSparse, nbrs: Neighbors, dest=None,
                   atol: float = 1e-5, active=None) -> None:
    """Assert the edge-slot iterate is feasible (on the host).

    Data rows (slots + local column) lie on the simplex; result rows are
    simplex rows or exactly empty; destination rows carry no result
    mass; padding slots hold exactly zero.  With `active` ([S] bool, a
    task pool's mask) inactive rows must be exactly inert (zero data
    mass, all-local, empty result rows) and the simplex checks run on
    the active rows."""
    data = phi_sp.data.cpu().numpy()
    local = phi_sp.local[..., 0].cpu().numpy()
    result = phi_sp.result.cpu().numpy()
    if dest is not None and isinstance(dest, torch.Tensor):
        dest = dest.cpu().numpy()
    if active is not None:
        act = (active.cpu().numpy() if isinstance(active, torch.Tensor)
               else np.asarray(active)).astype(bool)
        ina = ~act
        if not (data[ina] == 0.0).all():
            raise AssertionError("inactive task rows carry data mass")
        if not (result[ina] == 0.0).all():
            raise AssertionError("inactive task rows carry result mass")
        if not (local[ina] == 1.0).all():
            raise AssertionError("inactive task rows are not all-local")
        data, local, result = data[act], local[act], result[act]
        if dest is not None:
            dest = np.asarray(dest)[act]
    pad = ~nbrs.out_mask.cpu().numpy()[None]
    if not (data[np.broadcast_to(pad, data.shape)] == 0.0).all():
        raise AssertionError("nonzero mass on dead data slots")
    if not (result[np.broadcast_to(pad, result.shape)] == 0.0).all():
        raise AssertionError("nonzero mass on dead result slots")
    if data.size and (data.min() < -atol or local.min() < -atol):
        raise AssertionError("negative routing fraction")
    np.testing.assert_allclose(data.sum(-1) + local, 1.0, atol=atol,
                               err_msg="data rows off the simplex")
    rsum = result.sum(-1)
    ok = (np.abs(rsum - 1.0) < atol) | (np.abs(rsum) < atol)
    if not ok.all():
        raise AssertionError(
            f"result rows neither simplex nor empty: sums "
            f"{np.unique(np.round(rsum[~ok], 4))[:8]}")
    if dest is not None:
        d = np.asarray(dest)
        if not (rsum[np.arange(d.shape[0]), d] < atol).all():
            raise AssertionError("destination rows carry result mass")


def check_invariants(net: CECNetwork, phi_sp: PhiSparse, nbrs: Neighbors,
                     n_loop_tasks: Optional[int] = None,
                     atol: float = 1e-5, active=None) -> None:
    """`check_feasible` plus loop freedom (`is_loop_free` on the device,
    ⌈log₂V⌉ batched products of [S, V, V]); `n_loop_tasks` checks the
    first tasks only (the invariant is per task)."""
    check_feasible(phi_sp, nbrs, dest=net.dest, atol=atol, active=active)
    if n_loop_tasks is not None and n_loop_tasks < net.S:
        sl = slice(0, n_loop_tasks)
        net = dataclasses.replace(
            net, dest=net.dest[sl], r=net.r[sl], a=net.a[sl],
            w=net.w[sl], task_type=net.task_type[sl])
        phi_sp = PhiSparse(phi_sp.data[sl], phi_sp.local[sl],
                           phi_sp.result[sl])
    phi = sparse_to_phi(phi_sp, nbrs, net.V)
    if not bool(is_loop_free(net, phi)):
        raise AssertionError("replayed iterate has a support loop")


def iters_to_target(costs, target: float) -> int:
    """Index of the first cost <= target, or -1 if never reached."""
    for i, c in enumerate(costs):
        if c <= target:
            return i
    return -1


def iters_or_budget(iters: int, budget: int) -> int:
    """`iters_to_target`'s -1 as `budget + 1` (worse than using the whole
    budget), so sums and comparisons order never-reached outcomes."""
    return budget + 1 if iters < 0 else iters


def segment_seed(seed: int, k: int, stream: int = 0) -> int:
    """The seed of segment k's generator, from the engine generator's
    `initial_seed()`: the Theorem-2 masks' (stream 0) or the faults'
    (stream 1)."""
    entropy = [int(seed), int(k)] + ([int(stream)] if stream else [])
    hi, lo = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)


# ---------------------------------------------------------------- records
@dataclasses.dataclass
class EventRecord:
    """What one churn event did to the live iterate."""
    it: int                      # global iteration the event fired at
    event: object
    kind: str                    # "rate" | "topology" | "routing" |
                                 # "task" | "grow"
    cost_before: float           # last accepted cost on the old network
    cost_after: float            # repaired iterate's cost on the new one
    segment_costs: list = dataclasses.field(default_factory=list)
    segment_iters: int = 0       # iterations executed after the event
    # cold-baseline stats (play(cold_baseline=True), repair events only)
    warm_iters: Optional[int] = None
    cold_iters: Optional[int] = None
    cold_final: Optional[float] = None


# ----------------------------------------------------------------- engine
class ReplayEngine:
    """Event-driven streaming replay over a live `PhiSparse` iterate.

    driver="run" resumes `sgp.run_chunk` between events (`loop_driver`
    "fused", the default, or "host"; `run_opts` go to every chunk).
    driver="distributed" resumes the task-sharded driver
    (`distributed.run_distributed_chunk` over `mesh`, a
    `distributed.TaskMesh`; default `task_mesh()`): every event
    rebuilds the state from the warm iterate, as driver="run" does; its
    `run_opts` may set only variant, scaling and kappa, and it takes no
    `rng`, `pool` or `bucketed`.  Every rank replays the same schedule.
    `engine_impl` must be None: the port picks each kernel by its
    tensors' device.

    `fault_plan`, `fault_rng` and `guards` (`core.faults`, `core.guards`)
    thread the robustness layer through every warm segment: each
    segment's fresh driver state draws from its own fault generator
    (module docstring) and anchors a fresh guard carry at the repaired
    iterate; `guard_log` gathers the trips of every segment.

    bucketed=True runs every recursion over degree buckets (rebuilt on
    topology events).  `pool` (a `TaskPool`, `net` padded to its S_cap)
    admits arrivals into recycled slots; `rng` (a torch.Generator on the
    net's device) drives the Theorem-2 masks of `run_opts["async_frac"]`
    (module docstring).  invariant_checks (default on) runs
    `check_invariants` after every event, the loop-freedom closure over
    `invariant_loop_tasks` tasks; it reads the device, so benches pass
    False.  `graph_log` keeps the fused driver's CUDA graph stats of
    each chunk and stream (captures, capture seconds)."""

    def __init__(self, net: CECNetwork, phi0: Optional[PhiSparse] = None,
                 driver: str = "run", engine_impl: Optional[str] = None,
                 min_scale: float = 0.05, mesh=None,
                 run_opts: Optional[dict] = None,
                 loop_driver: Optional[str] = None,
                 bucketed: bool = False,
                 invariant_checks: bool = True,
                 invariant_loop_tasks: Optional[int] = 4,
                 fault_plan=None, fault_rng=None, guards=None,
                 rng: Optional[torch.Generator] = None,
                 pool: Optional[TaskPool] = None):
        if driver not in ("run", "distributed"):
            raise ValueError(f"unknown replay driver {driver!r}")
        if driver != "distributed" and mesh is not None:
            raise ValueError("mesh= needs driver='distributed'")
        if driver == "distributed":
            if bucketed:
                raise ValueError("bucketed replay needs driver='run' (the "
                                 "distributed step shards the padded tile)")
            if rng is not None:
                raise ValueError("the Theorem-2 generator (rng=) drives "
                                 "run_chunk's row masks; driver="
                                 "'distributed' does not consume it")
            if pool is not None:
                raise ValueError("a dynamic task pool needs driver='run': "
                                 "the distributed step does not thread "
                                 "the active mask")
            unsupported = set(run_opts or {}) - {"variant", "scaling",
                                                 "kappa"}
            if unsupported:
                raise ValueError(
                    f"run_opts {sorted(unsupported)} are not supported by "
                    "driver='distributed' (it takes variant, scaling and "
                    "kappa at init)")
        if engine_impl is not None:
            raise ValueError("engine_impl must be None: the port picks "
                             "each kernel by its tensors' device")
        if pool is not None and int(net.S) != pool.S_cap:
            raise ValueError(
                f"network has S={int(net.S)} task slots but the pool's "
                f"S_cap={pool.S_cap}; pad the network with "
                "network.pad_tasks(net, pool.S_cap) first")
        self.driver = driver
        self.mesh = mesh
        self.loop_driver = loop_driver
        self.run_opts = dict(run_opts or {})
        unknown = set(self.run_opts) - set(run_opt_keys())
        if unknown:
            raise ValueError(f"run_opts {sorted(unknown)} are not "
                             "options of run_chunk")
        if loop_driver is not None and driver == "run":
            self.run_opts.setdefault("driver", loop_driver)
        if self.run_opts.get("async_frac", 0.0) > 0.0 and rng is None:
            raise ValueError(
                "run_opts={'async_frac': ...} needs ReplayEngine(rng="
                "torch.Generator(...)): each segment draws its row masks "
                "from a generator derived from it")
        for gen in (rng, fault_rng):
            if gen is not None and gen.device.type != net.device.type:
                raise ValueError(f"the generator lies on {gen.device}, "
                                 f"the network on {net.device}")
        self.pool = pool
        self.admission_log: list = []        # drained, it-stamped pool log
        self.churn = ChurnState(net, pool=pool)
        self.net = net
        self.nbrs = build_neighbors(net.adj)
        self.bucketed = bucketed
        self.buckets = build_buckets(net.adj) if bucketed else None
        self.min_scale = min_scale
        self.invariant_checks = invariant_checks
        self.invariant_loop_tasks = invariant_loop_tasks
        self._rng = rng
        self._rng_segments = 0
        self.fault_plan = fault_plan
        self.guards = guards
        self._fault_seed = (0 if fault_rng is None
                            else fault_rng.initial_seed())
        self._fault_segments = 0
        self._guard_log: list = []           # closed segments' trips
        self._spt_cache: dict = {}           # dest key -> SPT result rows
        self.spt_cache_hits = 0
        self.graph_log: list = []
        self.records: list[EventRecord] = []
        self.cost_log: list[float] = []      # finished segments' costs
        self.total_iters = 0
        self._segment_open = False           # iterations attribute to
                                             # records[-1] only while open
        phi0 = spt_phi_sparse(net, self.nbrs) if phi0 is None else phi0
        if not isinstance(phi0, PhiSparse):
            raise TypeError("ReplayEngine iterates in slots: pass a "
                            "PhiSparse phi0 (e.g. spt_phi_sparse)")
        self._refresh_active()
        if self._active_dev is not None:
            # the slots the pool holds empty start inert, whatever φ⁰ says
            phi0 = mask_inactive_slots(phi0, self._active_dev)
        self._init_state(phi0)

    # ------------------------------------------------------------- driver
    def _segment_rng(self) -> torch.Generator:
        """The next segment's Theorem-2 generator (module docstring)."""
        gen = torch.Generator(device=self._rng.device)
        gen.manual_seed(segment_seed(self._rng.initial_seed(),
                                     self._rng_segments))
        self._rng_segments += 1
        return gen

    def _segment_fault_rng(self) -> torch.Generator:
        """The next segment's fault generator (module docstring)."""
        gen = torch.Generator(device=self.net.device)
        gen.manual_seed(segment_seed(self._fault_seed, self._fault_segments,
                                     stream=1))
        self._fault_segments += 1
        return gen

    def _refresh_active(self) -> None:
        """Upload the pool's mask (`TaskPool.active_for_engine`: None is
        the fixed-S pass-through)."""
        host = None if self.pool is None else self.pool.active_for_engine()
        self._active_dev = (None if host is None
                            else upload(host, self.net.device))

    def _drain_admissions(self) -> None:
        """The pool's new `AdmissionEvent`s into the engine's log, stamped
        with the global iteration count."""
        if self.pool is None:
            return
        for ev in self.pool.drain_log():
            self.admission_log.append(
                dataclasses.replace(ev, it=self.total_iters))

    def _init_state(self, phi_sp: PhiSparse) -> None:
        if self.driver == "distributed":
            self.state = dist.init_distributed_state(
                self.net, phi_sp, mesh=self.mesh, method="sparse",
                min_scale=self.min_scale,
                variant=self.run_opts.get("variant", "sgp"),
                scaling=self.run_opts.get("scaling", "adaptive"),
                kappa=self.run_opts.get("kappa", 0.0),
                fault_plan=self.fault_plan,
                fault_rng=(None if self.fault_plan is None
                           else self._segment_fault_rng()),
                guards=self.guards)
            self.mesh = self.state.mesh      # reused across re-inits
            return
        self.state = init_run_state(
            self.net, phi_sp, min_scale=self.min_scale, method="sparse",
            nbrs=self.nbrs, bucketed=self.bucketed, buckets=self.buckets,
            rng=None if self._rng is None else self._segment_rng(),
            fault_plan=self.fault_plan,
            fault_rng=(None if self.fault_plan is None
                       else self._segment_fault_rng()),
            guards=self.guards, active=self._active_dev)

    @property
    def phi(self) -> PhiSparse:
        """The live edge-slot iterate (under driver="distributed" the
        whole unpadded iterate, gathered over the ranks)."""
        if self.driver == "distributed":
            return dist.unpad_phi(self.state)
        return self.state.phi

    @property
    def costs(self) -> list:
        """The accepted-cost trajectory across every segment so far."""
        return self.cost_log + list(self.state.costs)

    @property
    def cost(self) -> float:
        return self.state.costs[-1]

    @property
    def guard_log(self) -> list:
        """Every `GuardEvent` tripped so far, across segments (each
        numbered within its segment, as its fresh driver state counts)."""
        return self._guard_log + list(self.state.guard_events)

    def _log_graph(self, stats) -> None:
        if stats:
            self.graph_log.append(dict(stats))

    def iterate(self, n_iters: int) -> list:
        """Advance the warm driver `n_iters` iterations; returns the
        accepted costs of this chunk.  Counters advance by the iterations
        executed (a σ blow-up or a tol exit stops early)."""
        if n_iters <= 0:
            return []
        before = len(self.state.costs)
        it_before = self.state.it
        self.state.graph_stats = None
        if self.driver == "distributed":
            dist.run_distributed_chunk(self.state, n_iters,
                                       driver=self.loop_driver)
        else:
            run_chunk(self.net, self.state, n_iters, **self.run_opts)
        self._log_graph(self.state.graph_stats)
        executed = self.state.it - it_before
        self.total_iters += executed
        new = list(self.state.costs[before:])
        if self.records and self._segment_open:
            self.records[-1].segment_costs.extend(new)
            self.records[-1].segment_iters += executed
        return new

    # ------------------------------------------------------------- events
    def _rebuild_mask(self, net_new: CECNetwork, event):
        """[S] bool forcing a moved destination's task onto the SPT."""
        if not isinstance(event, DestRedraw):
            return None
        rb = np.zeros(net_new.S, bool)
        rb[event.task] = True
        return upload(rb, net_new.device)

    def apply_event(self, event) -> EventRecord:
        """Fold one churn event into the live system.

        Rate events keep the iterate (still feasible); topology and
        routing events repair it with `refeasibilize_sparse` (a moved
        destination's task rebuilt); task events seed or clear their
        slot.  The driver state is then re-initialised from the WARM
        iterate, never from the SPT."""
        cost_before = float(self.state.costs[-1])
        kind = self.churn.apply(event)
        net_new = self.churn.network()
        phi = self.phi
        if kind in ("task", "grow"):
            self._refresh_active()
            if kind == "grow":
                phi = pad_phi_sparse(phi, int(net_new.S))
            phi = self._apply_task_repairs(net_new, phi)
        if kind in ("topology", "routing"):
            phi, self.nbrs = refeasibilize_sparse(
                net_new, phi, self.nbrs,
                rebuild_tasks=self._rebuild_mask(net_new, event))
            if self._active_dev is not None:
                # a whole-iterate repair may seed a slot the pool holds
                # empty (routing churn aimed at a departed task)
                phi = mask_inactive_slots(phi, self._active_dev)
            if self.bucketed:
                self.buckets = build_buckets(net_new.adj)
        if kind == "topology":
            # the memoized SPT rows derive from the adjacency
            self._spt_cache.clear()
        self.net = net_new
        self.cost_log.extend(self.state.costs)
        self._guard_log.extend(self.state.guard_events)
        self._init_state(phi)                 # warm re-baseline
        self._drain_admissions()
        if self.invariant_checks:
            check_invariants(self.net, self.phi, self.nbrs,
                             n_loop_tasks=self.invariant_loop_tasks,
                             active=(None if self.pool is None
                                     else self.pool.active))
        rec = EventRecord(it=self.total_iters, event=event, kind=kind,
                          cost_before=cost_before,
                          cost_after=float(self.state.costs[-1]))
        self.records.append(rec)
        self._segment_open = True
        return rec

    def _apply_task_repairs(self, net_new: CECNetwork,
                            phi: PhiSparse) -> PhiSparse:
        """The per-slot repairs of the last task event: seed an admitted
        slot from the memoized SPT rows, clear a departed one."""
        for op, slot in self.churn.last_task_repairs:
            if op == "seed":
                phi = seed_task_slot(phi, slot, self._spt_rows(net_new))
            else:
                phi = clear_task_slot(phi, slot)
        return phi

    def rebaseline_rates(self, r, task: Optional[int] = None,
                         n_iters: int = 0) -> EventRecord:
        """Fold a windowed request-rate estimate into the live system as
        a `RateSet` event (repaired and re-baselined warm), then advance
        `n_iters` iterations.  Returns the event's record."""
        rec = self.apply_event(RateSet(r, task=task))
        if n_iters > 0:
            self.iterate(n_iters)
        return rec

    # ------------------------------------------------------ fused stream
    def _spt_rows(self, net_new: CECNetwork):
        """Memoized `spt_result_slots` of the live graph, keyed by the
        destination vector (and, under a pool, by S and the active mask,
        so a recycled slot never reuses an earlier tenant's rows); the
        rows depend on the adjacency, the zero-flow link weights and the
        destinations, never on φ.  Topology events clear the cache."""
        key = self.churn.dest.tobytes()
        if self.pool is not None:
            key = (key, int(net_new.S), self.pool.active.tobytes())
        rows = self._spt_cache.get(key)
        if rows is None:
            rows = spt_result_slots(net_new, self.nbrs)
            self._spt_cache[key] = rows
        else:
            self.spt_cache_hits += 1
        return rows

    def _stream_eligibility(self) -> Optional[str]:
        """None if this engine can run fused streams, else why not."""
        if self.driver != "run":
            return ("driver='distributed' replays through its own chunk "
                    "driver")
        if self.run_opts.get("driver") == "host":
            return ("loop_driver='host' forces the per-iteration "
                    "reference loop")
        if self.run_opts.get("callback") is not None:
            return "per-iteration callbacks need the host loop"
        return None

    def _flush_stream(self, window: list, t_prev: int) -> int:
        """Run one maximal same-graph window, gaps and events, as one
        `FusedStream` with a single host read at its end, then fold its
        segments into the bookkeeping as the event loop would.  Returns
        the window's last event iteration."""
        if not window:
            return t_prev
        entering_costs = list(self.state.costs)
        entering_guards = list(self.state.guard_events)
        opts = {k: v for k, v in self.run_opts.items() if k != "driver"}
        stream = FusedStream(self.net, self.state, **opts)
        pending = []
        for (t_ev, event) in window:
            stream.advance(t_ev - t_prev)
            kind = self.churn.apply(event)
            if kind == "grow":
                raise AssertionError("the pool probe must break the window "
                                     "before an arrival that grows S")
            net_new = self.churn.network()
            repair = None
            if kind == "task":
                self._refresh_active()
                repairs = self.churn.last_task_repairs
                spt = (self._spt_rows(net_new)
                       if any(op == "seed" for op, _ in repairs) else None)

                def repair(p, _ops=repairs, _spt=spt):
                    for op, slot in _ops:
                        p = (seed_task_slot(p, slot, _spt) if op == "seed"
                             else clear_task_slot(p, slot))
                    return p
            elif kind == "routing":
                rebuild = self._rebuild_mask(net_new, event)
                spt = self._spt_rows(net_new)

                def repair(p, _net=net_new, _rb=rebuild, _spt=spt,
                           _act=self._active_dev):
                    p = refeasibilize_sparse_samegraph(
                        _net, p, self.nbrs, rebuild_tasks=_rb, spt_sp=_spt)
                    # pin inert slots, as apply_event does
                    return p if _act is None else mask_inactive_slots(p, _act)
            stream.rebaseline(
                net_new, repair=repair,
                fault_rng=(self._segment_fault_rng()
                           if self.fault_plan is not None else None),
                rng=self._segment_rng() if self._rng is not None else None,
                active=self._active_dev if kind == "task" else None)
            self.net = net_new
            pending.append((event, kind))
            t_prev = t_ev
        segments = stream.finish()
        self._log_graph(self.state.graph_stats)
        self._fold_stream(segments, pending, entering_costs,
                          entering_guards)
        self._drain_admissions()
        if self.invariant_checks:
            # at the window's end: a per-event check would read the device
            check_invariants(self.net, self.phi, self.nbrs,
                             n_loop_tasks=self.invariant_loop_tasks,
                             active=(None if self.pool is None
                                     else self.pool.active))
        return t_prev

    def _fold_stream(self, segments: list, pending: list,
                     entering_costs: list, entering_guards: list) -> None:
        """`iterate` and `apply_event`'s bookkeeping from the stream's
        segments: segment k closes with event k, the last stays open in
        `self.state` (its guard trips in `state.guard_events`)."""
        for k, (event, kind) in enumerate(pending):
            seg = segments[k]
            self.total_iters += seg["executed"]
            if self.records and self._segment_open:
                self.records[-1].segment_costs.extend(seg["accepted"])
                self.records[-1].segment_iters += seg["executed"]
            baseline = (entering_costs if k == 0
                        else [segments[k - 1]["cost_after"]])
            self.cost_log.extend(baseline + seg["accepted"])
            self._guard_log.extend((entering_guards if k == 0 else [])
                                   + seg["guard_events"])
            self.records.append(EventRecord(
                it=self.total_iters, event=event, kind=kind,
                cost_before=seg["cost_before"],
                cost_after=seg["cost_after"]))
            self._segment_open = True
        last = segments[-1]
        self.total_iters += last["executed"]
        if self.records and self._segment_open:
            self.records[-1].segment_costs.extend(last["accepted"])
            self.records[-1].segment_iters += last["executed"]

    def _play_stream(self, schedule: ChurnSchedule, tail_iters: int) -> dict:
        """`play`'s stream: every maximal run of same-graph events is one
        `FusedStream`; topology events (and an arrival that would grow
        the pool) break it and go through `apply_event`."""
        t_prev = 0
        window: list = []
        # a cloned pool replays the window's admissions ahead of the
        # stream, so an arrival that grows S breaks the window first
        probe = self.pool.clone() if self.pool is not None else None
        for (t_ev, event) in schedule.events:
            breaks = event_kind(event) == "topology"
            if not breaks and probe is not None:
                if probe.would_grow(event):
                    breaks = True
                elif isinstance(event, TaskArrive):
                    probe.admit(event)
                elif event_kind(event) == "task":
                    probe.release(int(event.task))
            if breaks:
                t_prev = self._flush_stream(window, t_prev)
                window = []
                self.iterate(t_ev - t_prev)
                self.apply_event(event)
                t_prev = t_ev
                if probe is not None:
                    probe = self.pool.clone()   # resync after the flush
            else:
                window.append((t_ev, event))
        t_prev = self._flush_stream(window, t_prev)
        self.iterate(tail_iters)
        self._segment_open = False
        return self.history()

    # --------------------------------------------------------------- play
    def play(self, schedule: ChurnSchedule, tail_iters: int = 5,
             cold_baseline: bool = False, rel_tol: float = 0.02,
             callback: Optional[Callable] = None,
             stream: Optional[bool] = None) -> dict:
        """Replay a whole schedule: iterate to each event's iteration,
        apply it, continue warm; `tail_iters` more after the last.

        cold_baseline=True runs, beside every repair (topology, routing
        or task) event's segment, a cold SPT restart on the same network
        for the same budget and records warm and cold iterations to the
        better final × (1 + rel_tol).  callback(record, engine) fires
        after each event.  stream=True runs the same-graph windows as
        fused streams (bit for bit the event loop; invariant checks at
        each window's end); None streams exactly when eligible and
        nothing observes the events (no invariant checks, cold baseline
        or callback)."""
        if stream is None:
            stream = (callback is None and not cold_baseline
                      and not self.invariant_checks
                      and self._stream_eligibility() is None)
        if stream:
            reason = self._stream_eligibility()
            if cold_baseline:
                reason = reason or ("cold_baseline probes re-solve per "
                                    "event on the host")
            if callback is not None:
                reason = reason or ("per-event callbacks observe records "
                                    "the stream only builds at its end")
            if reason:
                raise ValueError(f"stream=True: {reason}")
            return self._play_stream(schedule, tail_iters)
        t_prev = 0
        pending: Optional[EventRecord] = None
        for (t_ev, event) in schedule.events:
            self.iterate(t_ev - t_prev)
            self._finish_cold(pending, cold_baseline, rel_tol)
            pending = self.apply_event(event)
            if callback is not None:
                callback(pending, self)
            t_prev = t_ev
        self.iterate(tail_iters)
        self._finish_cold(pending, cold_baseline, rel_tol)
        # later iterate() calls must not join the last event's segment
        self._segment_open = False
        return self.history()

    def _finish_cold(self, rec: Optional[EventRecord], cold_baseline: bool,
                     rel_tol: float) -> None:
        """After `rec`'s segment ran warm, the cold SPT restart on the
        same network for the same budget, and both iterations-to-target.
        The probe is invisible: no callback, no tol exit."""
        if rec is None or not cold_baseline or rec.kind == "rate":
            return
        n = rec.segment_iters
        if n == 0:
            return
        cold0 = spt_phi_sparse(self.net, self.nbrs)
        cold = init_run_state(self.net, cold0, min_scale=self.min_scale,
                              method="sparse", nbrs=self.nbrs,
                              bucketed=self.bucketed, buckets=self.buckets)
        probe_opts = {k: v for k, v in self.run_opts.items()
                      if k not in ("callback", "tol")}
        run_chunk(self.net, cold, n, **probe_opts)
        warm_costs = [rec.cost_after] + rec.segment_costs
        target = min(warm_costs[-1], cold.costs[-1]) * (1.0 + rel_tol)
        rec.warm_iters = iters_to_target(warm_costs, target)
        rec.cold_iters = iters_to_target(cold.costs, target)
        rec.cold_final = float(cold.costs[-1])

    def history(self) -> dict:
        return {"costs": self.costs, "final_cost": self.cost,
                "records": self.records, "n_iters": self.total_iters,
                "guard_events": self.guard_log,
                "admission_events": list(self.admission_log)}
