"""Multi-pod serving request router: the paper's optimizer as the
serving layer's scheduler.

Cluster model (a CEC network, §II of the paper):
  node 0            gateway (the result destination of every request
                    class, distinct from the data sources)
  nodes 1..F        frontends (request entry; negligible compute)
  nodes F+1..F+P    pods (compute; a queueing cost at each pod's
                    token/s capacity; heterogeneous speed through w)
  links             gateway<->frontends and frontends<->pods (DCN),
                    pod<->pod ring (ICI), all congestible M/M/1 costs.

Request classes are tasks: class m has a prompt-token rate r at each
frontend and a_m, its generated / prompt length ratio (the result
flow).  `plan()` runs SGP to the Theorem-1 optimum on the sparse
edge-slot engine through the fused driver (`core.run`; on the card one
CUDA graph an iteration, K1 and K3 inside it), or task-sharded over
`torch.distributed` (`distributed=True`, `core.run_distributed`);
`on_pod_failure()` replays the paper's Fig. 5b adaptivity as a serving
failover, warm from the sparse iterate (`refeasibilize_sparse`).

The live-request bridge on top of the plan:

  observe()            windowed estimation: arriving requests fold into
                       per-(class, frontend) token rates.
  decide()             a request's offload decision served from the live
                       φ: a loop-free walk down the class's data splits
                       from the entry frontend to the pod that computes
                       locally (argmax a hop, or sampled with a numpy
                       generator so long-run pod frequencies match the
                       optimal fractional dispatch).
  maybe_rebaseline()   measured rates drifting past a threshold fold
                       into the solver as ONE `RateSet` event through a
                       `ReplayEngine`, warm, never a cold re-plan; under
                       a task pool unknown classes are admitted as
                       `TaskArrive` events and vanished ones depart.
  greedy_plan()        the deployed-heuristic baseline: each (class,
                       frontend) demand to the least-utilized pod,
                       congestion- and result-flow-blind.

The network lives on `device` (None: the card); the estimator, the
decision table and the pool are host numpy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import core
from ..convert import network_from_numpy


@dataclasses.dataclass(frozen=True)
class PodSpec:
    capacity: float            # tokens/s the pod can decode
    speed: float = 1.0         # relative per-token cost multiplier (1/w)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    dcn_capacity: float = 50.0   # gateway<->frontend, frontend<->pod
    ici_capacity: float = 200.0  # pod<->pod
    n_iters: int = 150
    window: float = 60.0         # rate-estimation window, seconds


class RateEstimator:
    """Sliding-window token-rate estimate per (class, frontend).

    `observe(s, f, tokens, t)` records one arriving request's prompt
    tokens at time `t` (seconds, any monotone clock); `rates(t)` returns
    the [S, F] tokens/s estimate over the trailing window."""

    def __init__(self, n_classes: int, n_frontends: int,
                 window: float = 60.0):
        self.window = float(window)
        self._events: deque = deque()          # (t, s, f, tokens)
        self._sum = np.zeros((n_classes, n_frontends))
        self._t = 0.0

    def observe(self, s: int, f: int, tokens: float, t: float) -> None:
        if t < self._t:
            raise ValueError(f"time went backwards: {t} < {self._t}")
        self._t = t
        self._events.append((t, s, f, float(tokens)))
        self._sum[s, f] += tokens
        self._evict()

    def _evict(self) -> None:
        horizon = self._t - self.window
        while self._events and self._events[0][0] <= horizon:
            _, s, f, tok = self._events.popleft()
            self._sum[s, f] -= tok

    def rates(self, t: Optional[float] = None) -> np.ndarray:
        if t is not None:
            if t < self._t:
                raise ValueError(f"time went backwards: {t} < {self._t}")
            self._t = t
            self._evict()
        return np.maximum(self._sum, 0.0) / self.window

    def ensure_rows(self, n_classes: int) -> None:
        """Grow the class axis to `n_classes` rows (an admission onto a
        task-pool rung beyond the estimator's construction size)."""
        extra = n_classes - self._sum.shape[0]
        if extra > 0:
            self._sum = np.vstack(
                [self._sum, np.zeros((extra, self._sum.shape[1]))])

    def ingest(self, s: int, f: int, tokens: float, t: float) -> None:
        """Fold one request observed BEFORE its class had a task slot
        (buffered during admission): `t` may lie in the past; the event
        deque is re-sorted so the window's eviction stays exact."""
        self._t = max(self._t, t)
        self._events.append((t, s, f, float(tokens)))
        if len(self._events) > 1 and self._events[-2][0] > t:
            self._events = deque(sorted(self._events))
        self._sum[s, f] += tokens
        self._evict()


def router_arrays(pods: List[PodSpec], n_frontends: int,
                  classes: Dict[str, float], demand,
                  cfg: RouterConfig = RouterConfig()) -> dict:
    """The cluster's CEC network as numpy arrays (`convert.
    network_from_numpy`'s fields): adjacency, DCN / ICI link capacities,
    pod compute capacities (1e-3 at the gateway and frontends), every
    class's results to the gateway, its prompt rates at the frontends,
    a_m, and w = 1 / speed at each pod."""
    F, P = n_frontends, len(pods)
    V = 1 + F + P
    adj = np.zeros((V, V), dtype=bool)
    caps = np.full((V, V), 1.0)
    for f in range(1, 1 + F):
        adj[0, f] = adj[f, 0] = True
        caps[0, f] = caps[f, 0] = cfg.dcn_capacity
        for p in range(1 + F, V):
            adj[f, p] = adj[p, f] = True
            caps[f, p] = caps[p, f] = cfg.dcn_capacity
    pod_ids = list(range(1 + F, V))
    for i, p in enumerate(pod_ids):
        q = pod_ids[(i + 1) % len(pod_ids)]
        if p != q:
            adj[p, q] = adj[q, p] = True
            caps[p, q] = caps[q, p] = cfg.ici_capacity
    comp_cap = np.full((V,), 1e-3)
    for i, spec in enumerate(pods):
        comp_cap[1 + F + i] = spec.capacity
    S = len(classes)
    r = np.zeros((S, V))
    r[:, 1:1 + F] = demand
    w = np.ones((S, V))
    for i, spec in enumerate(pods):
        w[:, 1 + F + i] = 1.0 / spec.speed
    return dict(adj=adj, link_params=caps, comp_params=comp_cap,
                dest=np.zeros((S,), np.int64), r=r,
                a=np.asarray([classes[c] for c in classes]), w=w,
                task_type=np.arange(S), link_family="queue",
                comp_family="queue")


def router_256(seed: int = 0) -> dict:
    """A full-size cluster: 1 gateway, 16 frontends, 256 pods (V = 273),
    pod capacities in [20, 40) and speeds in [0.8, 1.2), 16 classes with
    a_m from {0.05, 0.3, 1.0, 1.5, 2.0} and demand in [0.5, 2.0) per
    (class, frontend), 16 spare class slots (S_cap 32), all drawn from
    `RandomState(seed)` in that order.  Returns `RequestRouter`'s
    keyword arguments (bar `device`)."""
    rng = np.random.RandomState(seed)
    n_pods, n_frontends, n_classes = 256, 16, 16
    caps = rng.uniform(20.0, 40.0, n_pods)
    speeds = rng.uniform(0.8, 1.2, n_pods)
    a = rng.choice([0.05, 0.3, 1.0, 1.5, 2.0], n_classes)
    demand = rng.uniform(0.5, 2.0, (n_classes, n_frontends))
    return dict(pods=[PodSpec(float(c), float(s))
                      for c, s in zip(caps, speeds)],
                n_frontends=n_frontends,
                classes={f"class{m}": float(a[m]) for m in range(n_classes)},
                demand=demand, class_slots=16)


def feed_steady(router, rates: Dict[str, np.ndarray], t0: float = 0.0,
                seconds: float = 60.0, dt: float = 0.5,
                a: Optional[Dict[str, float]] = None) -> float:
    """Feed `router.observe` a steady stream for `seconds` after `t0`:
    every `dt` seconds, one request a (class, frontend) of rate × dt
    tokens, for each class name's per-frontend rates (zero rates
    skipped; `a` gives unknown classes' result ratios).  Any router with
    the `observe(name, frontend, tokens, t, a=)` surface takes it.
    Returns the last time."""
    t = t0
    for _ in range(int(round(seconds / dt))):
        t += dt
        for name, row in rates.items():
            kw = {"a": a[name]} if a and name in a else {}
            for f, rate in enumerate(row):
                if rate > 0.0:
                    router.observe(name, f, float(rate) * dt, t, **kw)
    return t


class RequestRouter:
    def __init__(self, pods: List[PodSpec], n_frontends: int,
                 classes: Dict[str, float], demand: np.ndarray,
                 cfg: RouterConfig = RouterConfig(), class_slots: int = 0,
                 admission_policy: str = "reject", device=None):
        """classes: name -> a_m (output/input ratio).  demand:
        [n_classes, n_frontends] prompt token rates.

        class_slots > 0 provisions a `core.TaskPool` with at least that
        many spare task slots (padded to the next power-of-two rung):
        observing a request of an UNKNOWN class stages it, and the next
        `maybe_rebaseline()` admits it as a `TaskArrive` through the warm
        live engine.  A known class whose windowed rate decays to zero
        departs the same way.  `admission_policy` (reject | queue |
        grow) decides what happens when the pool is exhausted.  The
        network lives on `device` (None: the card)."""
        self.pods = pods
        self.F = n_frontends
        self.P = len(pods)
        self.cfg = cfg
        self.class_names = list(classes)
        self.net = network_from_numpy(
            **router_arrays(pods, n_frontends, classes, demand, cfg),
            device=device)
        V = self.net.V
        pod_ids = list(range(1 + self.F, V))
        self.pod_nodes = pod_ids
        S = len(classes)
        if class_slots > 0:
            S_cap = core.next_pow2(S + class_slots)
            self.pool: Optional[core.TaskPool] = core.TaskPool(
                S, S_cap=S_cap, policy=admission_policy)
            self.net = core.pad_tasks(self.net, S_cap, n_active=S)
        else:
            self.pool = None
        # the initial plan: nearest-pod offloading (frontends never compute)
        self._phi_init = core.offload_phi(self.net, pod_ids)
        self.net = core.enforce_feasibility(self.net, margin=0.8,
                                            phi0=self._phi_init)
        self.nbrs = core.build_neighbors(self.net.adj)
        self.phi = None
        self.history = None
        self.method = "sparse"
        self.estimator = RateEstimator(int(self.net.S), self.F,
                                       window=cfg.window)
        self._run_opts: dict = {}
        self._live: Optional[core.ReplayEngine] = None
        self._phi_table: Optional[np.ndarray] = None   # dense data rows
        # dynamic-class admission (pool mode only)
        self._dynamic: Dict[str, int] = {}      # admitted name -> slot
        self._class_a: Dict[str, float] = dict(classes)
        self._staged: Dict[str, list] = {}      # unadmitted name -> events
        self._awaiting: List[str] = []          # names in emission order
        self._queued_names: List[str] = []      # names the pool queued
        self._adm_seen = 0                      # admission-log watermark

    @property
    def device(self) -> torch.device:
        return self.net.device

    # ------------------------------------------------------------------
    def plan(self, n_iters: Optional[int] = None,
             distributed: bool = False, method: str = "sparse",
             driver: str = "fused", run_opts: Optional[dict] = None):
        """Solve to the Theorem-1 optimum and return `summary()`.

        method / driver default to the production path (edge-slot
        engine, fused driver); `distributed=True` runs the task-sharded
        driver over `core.task_mesh()` (the world, or a world of one).
        run_opts forwards any other driver option: unknown or
        wrapper-owned keys are rejected loudly (`core.validate_run_opts`).
        """
        runner = core.run_distributed if distributed else core.run
        reserved = ("method", "driver")
        supported = core.run_opt_keys(runner) - {
            "min_scale", "rng", "mesh", "bucketed", "fault_plan",
            "fault_rng", "guards", "nbrs", "buckets"}
        opts = core.validate_run_opts(
            run_opts, supported, "RequestRouter.plan"
            + (" (distributed)" if distributed else ""), reserved=reserved)
        phi0 = self.phi if self.phi is not None else self._phi_init
        if method == "sparse" and not isinstance(phi0, core.PhiSparse):
            phi0 = core.phi_to_sparse(phi0, self.nbrs)
        self.phi, self.history = runner(
            self.net, phi0, n_iters=n_iters or self.cfg.n_iters,
            method=method, driver=driver, **opts)
        self.method = method
        self._run_opts = opts
        self._live = None           # the next rebaseline re-anchors here
        self._phi_table = None
        return self.summary()

    def on_pod_failure(self, pod_index: int, n_iters: Optional[int] = None):
        """Fail a pod and re-plan from the surviving strategy (warm: the
        paper's adaptivity, Theorem 2).  A sparse iterate is repaired in
        its layout (`refeasibilize_sparse` re-slots it onto the failed
        graph's tiles); a dense one through `refeasibilize`."""
        node = 1 + self.F + pod_index
        self.net = core.fail_node(self.net, node)
        self._live = None
        self._phi_table = None
        if isinstance(self.phi, core.PhiSparse):
            self.phi, self.nbrs = core.refeasibilize_sparse(
                self.net, self.phi, self.nbrs)
        else:
            self.nbrs = core.build_neighbors(self.net.adj)
            if self.phi is not None:
                self.phi = core.refeasibilize(self.net, self.phi)
        return self.plan(n_iters=n_iters, method=self.method,
                         run_opts=self._run_opts or None)

    # ------------------------------------------------- live request bridge
    def class_index(self, class_name: str) -> int:
        if class_name in self._dynamic:
            return self._dynamic[class_name]
        return self.class_names.index(class_name)

    def observe(self, class_name: str, frontend: int, tokens: float,
                t: float, a: float = 1.0) -> None:
        """Fold one arriving request (its prompt tokens, at time `t`) into
        the windowed estimate.  Under a task pool an UNKNOWN class is
        staged instead of raising: its requests buffer until the next
        `maybe_rebaseline` emits a `TaskArrive` for it (`a`, the new
        class's output/input ratio, is recorded at first sight)."""
        try:
            s = self.class_index(class_name)
        except ValueError:
            if self.pool is None:
                raise
            self._class_a.setdefault(class_name, float(a))
            self._staged.setdefault(class_name, []).append(
                (frontend, float(tokens), float(t)))
            return
        self.estimator.observe(s, frontend, tokens, t)

    def _planned_rates(self) -> np.ndarray:
        return self.net.r[:, 1:1 + self.F].cpu().numpy()

    def drift(self) -> float:
        """Relative L1 gap between the windowed estimate and the rates
        the current plan was solved for."""
        planned = self._planned_rates()
        est = self.estimator.rates()
        return float(np.abs(est - planned).sum()
                     / max(planned.sum(), 1e-9))

    def _ensure_live(self) -> "core.ReplayEngine":
        if self.phi is None:
            self.plan()
        if self._live is None:
            self._live = core.ReplayEngine(
                self.net, phi0=self._sparse_phi(),
                run_opts=dict(self._run_opts) or None,
                invariant_checks=False, pool=self.pool)
        return self._live

    def _staged_rate(self, events: list) -> np.ndarray:
        """Windowed per-frontend token rates of a staged (not yet
        admitted) class, from its buffered observations."""
        now = max([self.estimator._t] + [t for _, _, t in events])
        horizon = now - self.cfg.window
        rate = np.zeros(self.F)
        for f, tok, t in events:
            if t > horizon:
                rate[f] += tok
        return rate / self.cfg.window

    def _bind(self, name: str, slot: int, admitted: list) -> None:
        """An admission landed: map the class to its slot and fold its
        buffered requests into the estimator."""
        self._dynamic[name] = slot
        self.estimator.ensure_rows(int(self._live.net.S))
        for f, tok, t in self._staged.pop(name, []):
            self.estimator.ingest(slot, f, tok, t)
        admitted.append(name)

    def _sync_pool(self) -> dict:
        """Pair the admission log's new records with the class names
        emitted: the pool is strictly FIFO (lowest free slot admits, FIFO
        queue), so records pair with names in emission order."""
        out: dict = {"admitted": [], "rejected": [], "queued": []}
        log = self._live.admission_log
        for ev in log[self._adm_seen:]:
            if ev.action in ("admit", "grow"):
                self._bind(self._awaiting.pop(0), ev.slot, out["admitted"])
            elif ev.action == "reject":
                name = self._awaiting.pop(0)
                self._staged.pop(name, None)
                out["rejected"].append(name)
            elif ev.action == "queue":
                name = self._awaiting.pop(0)
                self._queued_names.append(name)
                out["queued"].append(name)
            elif ev.action == "dequeue":
                self._bind(self._queued_names.pop(0), ev.slot,
                           out["admitted"])
        self._adm_seen = len(log)
        return out

    def maybe_rebaseline(self, threshold: float = 0.25,
                         n_iters: int = 30) -> dict:
        """Re-anchor the plan on the measured rates IF the drift exceeds
        `threshold`, as a warm `ReplayEngine` rebaseline (a `RateSet`
        event + `n_iters` warm iterations), never a cold re-plan.  Under
        a task pool this is also the admission point: staged classes are
        emitted as `TaskArrive` events and vanished dynamic classes
        (windowed rate decayed to zero) as `TaskDepart`, each folded warm
        through the live engine."""
        d = self.drift()
        arrivals, departures = [], []
        if self.pool is not None:
            for name, events in list(self._staged.items()):
                rate = self._staged_rate(events)
                if rate.sum() > 0.0:
                    arrivals.append((name, rate))
                else:                       # every observation expired
                    del self._staged[name]
            est = self.estimator.rates()
            for name, slot in list(self._dynamic.items()):
                if est[slot].sum() <= 0.0:
                    departures.append((name, slot))
        if d <= threshold and not arrivals and not departures:
            return {"drift": d, "rebaselined": False, "admissions": {}}
        live = self._ensure_live()
        for name, rate in arrivals:
            r_row = np.zeros(int(self.net.V))
            r_row[1:1 + self.F] = rate
            self._awaiting.append(name)
            live.apply_event(core.TaskArrive(
                r=r_row, dest=0, a=self._class_a.get(name, 1.0)))
        for name, slot in departures:
            del self._dynamic[name]
            live.apply_event(core.TaskDepart(slot))
        admissions = self._sync_pool() if self.pool is not None else {}
        if d > threshold:
            r_new = np.zeros(tuple(live.net.r.shape))
            rates = self.estimator.rates()
            r_new[:rates.shape[0], 1:1 + self.F] = rates
            if self.pool is not None:
                r_new[~self.pool.active] = 0.0   # inert slots stay inert
            live.rebaseline_rates(r_new, n_iters=0)
        live.iterate(n_iters)
        self.net = live.net
        self.phi = live.phi
        self.nbrs = live.nbrs
        self.method = "sparse"
        self._phi_table = None
        return {"drift": d, "rebaselined": True, "admissions": admissions,
                "task_events": len(arrivals) + len(departures),
                "cost": float(live.cost)}

    def _sparse_phi(self) -> core.PhiSparse:
        if self.phi is None:
            self.plan()
        if isinstance(self.phi, core.PhiSparse):
            return self.phi
        return core.phi_to_sparse(self.phi, self.nbrs)

    def _decision_table(self) -> np.ndarray:
        """The dense per-class data rows [S, V, V+1] of the live φ (a host
        copy, rebuilt after every plan, failover and rebaseline)."""
        if self._phi_table is None:
            dense = core.as_dense_phi(self._sparse_phi(), self.net)
            self._phi_table = dense.data.cpu().numpy()
        return self._phi_table

    def decide(self, class_name: str, frontend: int, rng=None) -> int:
        """A request's offload decision from the live φ: walk the class's
        data splits from the entry frontend until a node computes
        locally, and return that pod's index.  rng=None takes the argmax
        split at every hop; a numpy generator samples proportionally
        (`rng.choice`), so the long-run pod frequencies reproduce the
        optimal fractional dispatch.  Loop freedom bounds the walk at V
        hops."""
        s = self.class_index(class_name)
        table = self._decision_table()
        V = self.net.V
        v = 1 + frontend
        for _ in range(V):
            row = table[s, v]
            k = (int(np.argmax(row)) if rng is None
                 else int(rng.choice(row.shape[0], p=row / row.sum())))
            if k == V:                          # local: compute here
                if v in self.pod_nodes:
                    return v - (1 + self.F)
                break                           # non-pod compute
            v = k
        raise RuntimeError(
            f"φ walk from frontend {frontend} never reached a pod for "
            f"class {class_name!r}: the plan is stale or infeasible")

    def greedy_plan(self) -> dict:
        """The deployed-heuristic baseline: route each (class, frontend)
        demand entirely to the least-utilized pod, largest demands first,
        blind to congestion (no queueing model) and to results (a_m).
        Returns the induced φ and its true network cost, to set beside
        `plan()`'s optimum."""
        demand = self._planned_rates()
        caps = np.array([p.capacity for p in self.pods])
        speeds = np.array([p.speed for p in self.pods])
        load = np.zeros(self.P)
        choice = np.zeros(demand.shape, np.int32)
        order = sorted(np.ndindex(*demand.shape),
                       key=lambda sf: -demand[sf])
        for s, f in order:
            util = (load + demand[s, f]) / np.maximum(caps * speeds, 1e-9)
            p = int(np.argmin(util))
            choice[s, f] = p
            load[p] += demand[s, f]
        # nearest-pod routing, frontend rows overridden by the choice
        phi = core.offload_phi(self.net, self.pod_nodes)
        data = phi.data.cpu().numpy().copy()
        for s, f in np.ndindex(*demand.shape):
            row = np.zeros(data.shape[-1], np.float32)
            row[1 + self.F + choice[s, f]] = 1.0
            data[s, 1 + f] = row
        phi = core.Phi(torch.as_tensor(data, device=self.device),
                       phi.result)
        return {"phi": phi, "assignment": choice,
                "total_cost": float(core.total_cost(self.net, phi)),
                "pod_load": load}

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """The plan's total cost, pod utilizations, the [class, pod]
        dispatch (computed workload) and the Theorem-1 residual."""
        kwargs = ({"method": "sparse", "nbrs": self.nbrs}
                  if isinstance(self.phi, core.PhiSparse) else {})
        fl = core.compute_flows(self.net, self.phi, **kwargs)
        pod_load = fl.G[1 + self.F:].cpu().numpy()
        pod_cap = self.net.comp_cost.params[1 + self.F:].cpu().numpy()
        return {
            "total_cost": float(core.cost_of_flows(self.net, fl)),
            "pod_utilization": pod_load / np.maximum(pod_cap, 1e-9),
            "dispatch": fl.g[:, 1 + self.F:].cpu().numpy(),
            "residual": core.theorem1_residual(self.net, self.phi),
        }
