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
from .network import (CECNetwork, PhiSparse, build_neighbors, compute_flows,
                      resolve_device, spt_phi_sparse)


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
                        phi0: PhiSparse | None = None) -> CECNetwork:
    """Scale queue capacities so φ⁰ keeps flows below margin·SAT·cap.

    φ⁰ is evaluated on the sparse engine at every size (the reference
    uses its dense solve up to V = 200; the two agree to float32
    rounding)."""
    nbrs = build_neighbors(net.adj)
    phi0 = spt_phi_sparse(net, nbrs) if phi0 is None else phi0
    fl = compute_flows(net, phi0, "sparse", nbrs=nbrs)
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
