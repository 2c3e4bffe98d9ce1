"""Table II scenario sampler.

Draws tasks, rates, result ratios, computation weights and cost
parameters from `np.random.RandomState(spec.seed)` in the same order as
the JAX package's `core/scenarios.py`, so both packages build the same
scenario, then scales queue capacities until φ⁰ (pure-local compute,
shortest-path result routing) keeps every flow below
margin · SAT · capacity.  Float64 draws become float32 tensors, as the
reference's arrays do with 64-bit mode off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import topologies
from .costs import SAT, Cost
from .network import (DENSE_V_LIMIT, CECNetwork, Phi, PhiSparse,
                      build_neighbors, compute_flows, resolve_device,
                      spt_phi, spt_phi_sparse)


@dataclasses.dataclass
class ScenarioSpec:
    topology: str = "connected_er"
    V: Optional[int] = None          # topology default if None
    S: int = 15                      # number of tasks
    R: int = 5                       # active data sources per task
    M: int = 5                       # computation types
    link: str = "queue"              # 'linear' | 'queue'
    comp: str = "queue"
    d_mean: float = 10.0             # mean link cap (queue) / unit cost (linear)
    s_mean: float = 12.0             # mean compute cap / speed
    r_min: float = 0.5
    r_max: float = 1.5
    a_mean: float = 0.5              # exponential mean, truncated [0.1, 5]
    seed: int = 0


TABLE_II = {
    "connected_er": ScenarioSpec("connected_er", 20, 15, 5, 5, "queue", "queue", 10, 12),
    "balanced_tree": ScenarioSpec("balanced_tree", 15, 20, 5, 5, "queue", "queue", 20, 15),
    "fog": ScenarioSpec("fog", 19, 30, 5, 5, "queue", "queue", 20, 17),
    "abilene": ScenarioSpec("abilene", 11, 10, 3, 5, "queue", "queue", 15, 10),
    "lhc": ScenarioSpec("lhc", 16, 30, 5, 5, "queue", "queue", 15, 15),
    "geant": ScenarioSpec("geant", 22, 40, 7, 5, "queue", "queue", 20, 20),
    "sw_linear": ScenarioSpec("small_world", 100, 120, 10, 5, "linear", "linear", 20, 20),
    "sw_queue": ScenarioSpec("small_world", 100, 120, 10, 5, "queue", "queue", 20, 20),
    # beyond the paper's Table II: the sparse engine at V ~ 10^3 - 10^4
    "sw_1000": ScenarioSpec("small_world", 1000, 64, 10, 5, "queue", "queue", 30, 30),
    "grid_1024": ScenarioSpec("grid", 1024, 64, 10, 5, "queue", "queue", 30, 30),
    "ba_1000": ScenarioSpec("barabasi_albert", 1000, 64, 10, 5, "queue", "queue", 30, 30),
    "ba_10000": ScenarioSpec("barabasi_albert", 10000, 16, 5, 5, "queue", "queue", 30, 30),
}


def _mk_adj(spec: ScenarioSpec) -> np.ndarray:
    gen = topologies.TOPOLOGIES[spec.topology]
    if spec.topology == "connected_er":
        return gen(V=spec.V or 20, seed=spec.seed)
    if spec.topology == "small_world":
        V = spec.V or 100
        return gen(V=V, n_short=V, n_long=int(1.2 * V), seed=spec.seed)
    if spec.topology == "barabasi_albert":
        return gen(V=spec.V or 1000, m=2, seed=spec.seed)
    if spec.topology == "grid":
        side = int(round((spec.V or 1024) ** 0.5))
        if side * side != (spec.V or 1024):
            raise ValueError(f"grid topology needs a square V, got {spec.V}")
        return gen(side)
    return gen()


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def make_scenario(spec: ScenarioSpec, rate_scale: float = 1.0,
                  feasibility_margin: float = 0.75,
                  device=None) -> CECNetwork:
    """Sample a scenario onto `device` (None: the card)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(spec.seed)
    adj = _mk_adj(spec)
    V = adj.shape[0]
    S, M = spec.S, spec.M

    dest = rng.randint(0, V, size=S)
    ttype = rng.randint(0, M, size=S)
    a_m = np.clip(rng.exponential(spec.a_mean, size=M), 0.1, 5.0)
    r = np.zeros((S, V))
    for s in range(S):
        src = rng.choice(V, size=min(spec.R, V), replace=False)
        r[s, src] = rng.uniform(spec.r_min, spec.r_max, size=len(src)) * rate_scale

    w_im = rng.uniform(1.0, 5.0, size=(V, M))
    w = w_im[:, ttype].T                      # [S, V]
    a = a_m[ttype]                            # [S]

    d_ij = rng.uniform(0.0, 2.0 * spec.d_mean, size=(V, V))
    d_ij = np.where(adj, np.maximum(d_ij, 0.05 * spec.d_mean), 1.0)
    if spec.comp == "queue":
        s_i = np.maximum(rng.exponential(spec.s_mean, size=V),
                         0.05 * spec.s_mean)
    else:
        s_i = rng.uniform(0.0, 2.0 * spec.s_mean, size=V) + 1e-2

    net = CECNetwork(
        adj=torch.as_tensor(adj, device=dev),
        link_cost=Cost(spec.link, _f32(d_ij, dev)),
        comp_cost=Cost(spec.comp, _f32(s_i, dev)),
        dest=torch.as_tensor(dest, device=dev).long(),
        r=_f32(r, dev), a=_f32(a, dev), w=_f32(w, dev),
        task_type=torch.as_tensor(ttype, device=dev).long(),
    )
    if spec.link == "queue" or spec.comp == "queue":
        net = enforce_feasibility(net, margin=feasibility_margin)
    return net


def enforce_feasibility(net: CECNetwork, margin: float = 0.75,
                        phi0: Phi | PhiSparse | None = None) -> CECNetwork:
    """Scale queue capacities so φ⁰ keeps flows below margin·SAT·cap.

    As in the reference, φ⁰ is measured with the dense LU solve up to
    V = DENSE_V_LIMIT and on the sparse engine above it (a `phi0` given
    in the edge-slot layout is always measured sparse)."""
    if net.V > DENSE_V_LIMIT or isinstance(phi0, PhiSparse):
        nbrs = build_neighbors(net.adj)
        phi0 = spt_phi_sparse(net, nbrs) if phi0 is None else phi0
        fl = compute_flows(net, phi0, "sparse", nbrs=nbrs)
    else:
        fl = compute_flows(net, spt_phi(net) if phi0 is None else phi0,
                           "dense")
    limit = margin * SAT
    dev = net.device
    if net.link_cost.family == "queue":
        F = fl.F.cpu().numpy()
        cap = net.link_cost.params.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            need = np.where(cap > 0, F / (limit * np.maximum(cap, 1e-30)), 0.0)
        scale = max(1.0, float(np.max(need)))
        net = dataclasses.replace(
            net, link_cost=Cost("queue", _f32(cap * scale, dev)))
    if net.comp_cost.family == "queue":
        G = fl.G.cpu().numpy()
        cap = net.comp_cost.params.cpu().numpy()
        need = G / (limit * np.maximum(cap, 1e-30))
        scale = max(1.0, float(np.max(need)))
        net = dataclasses.replace(
            net, comp_cost=Cost("queue", _f32(cap * scale, dev)))
    return net


# ------------------------------------------------------- failures
def hub_node(net: CECNetwork) -> int:
    """The highest-out-degree node: the most damaging single failure."""
    return int(np.argmax(net.adj.cpu().numpy().sum(axis=1)))


def churn_hub(net: CECNetwork) -> int:
    """The busiest node that is not a task destination (failing a
    destination drops its tasks' rates, so the cost change would
    measure vanished load instead of routing adaptation)."""
    dests = set(int(d) for d in net.dest.cpu().numpy())
    for i in np.argsort(-net.adj.cpu().numpy().sum(axis=1)):
        if int(i) not in dests:
            return int(i)
    return hub_node(net)        # every node is a destination (tiny nets)


def churn_schedule(name: str, net: CECNetwork):
    """The canned churn schedules of the replay engine, as the reference
    draws them: "<scenario>_churn" for every TABLE_II row (a rate surge,
    the failure of the busiest non-destination node, a link flap while
    it is down, its recovery, the link's restore, task 0's sources
    re-drawn, the load dropping back) and "<scenario>_taskchurn" for the
    task-pool mixes (`net` then the padded network `taskchurn_scenario`
    returns)."""
    from .events import (ChurnSchedule, LinkCut, LinkRestore, NodeFail,
                         NodeRecover, RateScale, SourceRedraw)
    if name.endswith("_taskchurn"):
        return _taskchurn_schedule(name, net)
    base = name[:-len("_churn")] if name.endswith("_churn") else name
    if base not in TABLE_II:
        raise KeyError(f"no churn schedule for scenario {name!r}")
    hub = churn_hub(net)
    adj = net.adj.cpu().numpy()
    # a busy link away from the hub (flapped while the hub is down); on
    # hub-dominated graphs a hub edge (then a no-op while it is down)
    order = np.argsort(-adj.sum(axis=1))
    u = v = None
    for i in order:
        if i == hub:
            continue
        js = [j for j in np.nonzero(adj[i])[0] if j != hub]
        if js:
            u, v = int(i), int(js[0])
            break
    if u is None:
        u, v = hub, int(np.nonzero(adj[hub])[0][0])
    events = (
        (2, RateScale(1.5)),                  # global rate surge
        (5, NodeFail(hub)),                   # worst-case failure
        (9, LinkCut(u, v)),                   # link flap, down...
        (12, NodeRecover(hub)),               # ...the hub returns
        (15, LinkRestore(u, v)),              # ...and the link
        (17, SourceRedraw(0, seed=net.S)),    # task 0's sources move
        (19, RateScale(0.75)),                # load drops back off
    )
    return ChurnSchedule(events, name=f"{base}_churn")


def taskchurn_scenario(name: str, free: int = 4, policy: str = "reject",
                       rate_scale: float = 1.0, device=None):
    """(net, pool) for task-churn replay: TABLE_II's `name` with its last
    `free` task slots deactivated into pool headroom (S_cap pinned to
    the spec's S), on `device` (None: the card).  The pool has headroom
    from the start, so the engine threads the active mask from
    iteration 0 and arrivals change values only."""
    from .events import TaskPool
    from .network import pad_tasks
    base = make_scenario(TABLE_II[name], rate_scale=rate_scale,
                         device=device)
    S = int(base.S)
    if not (0 < free < S):
        raise ValueError(f"free={free} outside (0, {S})")
    net = pad_tasks(base, S, n_active=S - free)
    pool = TaskPool(S - free, S_cap=S, policy=policy)
    return net, pool


def _taskchurn_schedule(name: str, net: CECNetwork):
    """The canned task-pool mix ("<scenario>_taskchurn"): seeded arrivals
    (one into a freshly recycled slot), a departure, and rate and source
    churn, every event on the same graph."""
    from .events import (ChurnSchedule, RateScale, SourceRedraw,
                         TaskArrive, TaskDepart)
    base = name[:-len("_taskchurn")]
    if base not in TABLE_II:
        raise KeyError(f"no task-churn schedule for scenario {name!r}")
    V = int(net.V)
    rng = np.random.RandomState(V + 7)

    def arrival():
        src = rng.choice(V, size=2, replace=False)
        row = np.zeros(V)
        row[src] = rng.uniform(0.3, 0.8, size=2)
        return TaskArrive(row, dest=int(rng.randint(V)),
                          a=float(rng.uniform(0.3, 0.9)))

    events = (
        (2, RateScale(1.2)),                # load surge
        (4, arrival()),                     # claims the first free slot
        (6, TaskDepart(0)),                 # slot 0 leaves...
        (8, arrival()),                     # ...and is recycled here
        (10, SourceRedraw(1, seed=V)),      # a surviving task drifts
        (12, arrival()),                    # more headroom claimed
        (14, RateScale(0.85)),              # load backs off
    )
    return ChurnSchedule(events, name=f"{base}_taskchurn")


def fail_arrays(adj: np.ndarray, r: np.ndarray, dest: np.ndarray,
                comp: np.ndarray, comp_family: str, node: int):
    """`fail_node` on host arrays: (adj, r, comp) with `node` failed, new
    arrays (the inputs are not written)."""
    adj = adj.copy()
    adj[node, :] = False
    adj[:, node] = False
    r = r.copy()
    r[:, node] = 0.0
    r[dest == node, :] = 0.0
    comp = comp.copy()
    comp[node] = 1e-3 if comp_family == "queue" else 1e6
    return adj, r, comp


def fail_node(net: CECNetwork, node: int) -> CECNetwork:
    """Paper Fig. 5b: node failure.  Its links are removed (the row and
    column stay, empty), its compute is disabled, its exogenous inputs
    stop, and the tasks destined to it are dropped (rates zeroed) since
    their results can no longer be delivered."""
    dev = net.device
    adj, r, comp = fail_arrays(
        net.adj.cpu().numpy(), net.r.cpu().numpy(), net.dest.cpu().numpy(),
        net.comp_cost.params.cpu().numpy(), net.comp_cost.family, node)
    return dataclasses.replace(
        net, adj=torch.as_tensor(adj, device=dev), r=_f32(r, dev),
        comp_cost=Cost(net.comp_cost.family, _f32(comp, dev)))
