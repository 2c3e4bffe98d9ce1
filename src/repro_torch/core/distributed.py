"""Distributed SGP on `torch.distributed`: Algorithm 1 sharded over tasks.

The paper distributes Algorithm 1 over network nodes with a broadcast
protocol.  On a set of accelerators the natural decomposition is over
TASKS: each rank owns a contiguous shard of the |S| tasks (a task's
routing variables, traffic solves, marginal recursions and QP
projections are all task-local), and the only cross-task coupling, the
total link flows F and workloads G (the paper's measurement phase), is
ONE `all_reduce` an iteration: the [V, Dmax] edge-slot F tile (dense
[V, V] under the dense engines) and G, concatenated into one buffer.

A `TaskMesh` holds the process group, this rank's place in it and the
device.  `task_mesh()` with no process group initialised makes a world
of one from an in-process store (NCCL for tensors on the card, gloo on
the CPU); given a group, it uses that group.  Each rank holds the whole
(replicated) network and tiles and its own task shard of φ and of the
per-task traffic; F, G, the cost and every accept / σ decision are the
same on every rank, so both drivers of `sgp.run_chunk` run the shard
unchanged with the mesh in the step (`_sgp_step_flows_impl(mesh=)`).
On the card the fused driver captures the iteration, the all-reduce
included, into one CUDA graph (an NCCL mesh: gloo's collectives run on
the host and cannot be captured, so the fused driver refuses a gloo mesh
on the card).  A collective always takes the ranks' own tensors, on the
card too under gloo.

Fault injection keeps the reference's contract: every rank draws the
same faults from an identically seeded generator, and the corruption's
task index is drawn over the global task axis and applied by the one
rank that owns it.  The guards' φ sentinels reduce over the ranks (one
more all-reduce, of three flags, an iteration).

The node axis of the measurement can be sharded too
(`task_node_mesh`, `build_node_partition`, `node_flows_carry_and_cost`):
nodes are cut into contiguous blocks and each round of the traffic
recursions exchanges only the boundary rows (one `all_gather` a round,
the stop flag all-reduced).  The halo recursion folds with the plain
`kernels.ref.fold_reduce`, as the reference does.

Where the reference differs: under scaling="paper" the port's step takes
κ = 1 as `run` does, and, as the reference's distributed driver, never
refreshes the sups.  `engine_impl` must be None (the port picks each
kernel by its tensors' device).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ref import fold_reduce
from .costs import Cost
from .faults import draw_faults
from .network import (CECNetwork, FlowsCarry, Neighbors, Phi, PhiSparse,
                      _all_reduce_FG, _phi_edge_views, build_buckets,
                      build_neighbors, compute_flows, cost_of_flows,
                      gather_edges, phi_to_sparse, resolve_device,
                      sparse_to_phi)
from .sgp import (RunState, _sgp_propose_impl, _sgp_step_flows_impl,
                  init_run_state, run_chunk)

AXIS = "tasks"
NODE_AXIS = "nodes"

__all__ = ["AXIS", "NODE_AXIS", "TaskMesh", "NodeMesh", "task_mesh",
           "task_node_mesh", "pad_tasks", "make_distributed_step",
           "make_distributed_step_flows", "DistributedRunState",
           "init_distributed_state", "rebaseline_distributed_state",
           "run_distributed_chunk", "unpad_phi", "run_distributed",
           "NodePartition", "build_node_partition",
           "node_flows_carry_and_cost"]


# ------------------------------------------------------------------ meshes
@dataclasses.dataclass(frozen=True)
class TaskMesh:
    """One axis of ranks: a process group, this rank's index in it, its
    size and the device the ranks compute on."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def captures(self) -> bool:
        """Whether the collective can be captured in a CUDA graph."""
        return self.device.type != "cuda" or "nccl" in self.backend

    def all_reduce_(self, buf: torch.Tensor, op=None) -> torch.Tensor:
        """Reduce `buf` over the axis in place (sum by default)."""
        op = dist.ReduceOp.SUM if op is None else op
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's `t` (same shape), in rank order."""
        t = t.contiguous()
        if self.size == 1:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out


def _ensure_world(dev: torch.device) -> None:
    """A world of one from an in-process store, if no process group is
    initialised: NCCL for the card's tensors, gloo for the CPU's."""
    if dist.is_initialized():
        return
    backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
               and dist.is_nccl_available() else "gloo")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _axis(group, dev: torch.device) -> TaskMesh:
    return TaskMesh(group=group, rank=dist.get_rank(group),
                    size=dist.get_world_size(group), device=dev,
                    backend=str(dist.get_backend(group)))


def task_mesh(group=None, device=None) -> TaskMesh:
    """The 1-D task mesh over `group` (default: the whole world, a world
    of one made here if none is initialised) on `device` (None: the
    card)."""
    dev = resolve_device(device)
    _ensure_world(dev)
    return _axis(dist.group.WORLD if group is None else group, dev)


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """A (tasks × nodes) mesh: `tasks` is this rank's axis across task
    blocks (the ranks holding its node block), `nodes` its axis across
    node blocks (the ranks holding its task block).  Rank r sits at
    (r // n_nodes, r % n_nodes)."""
    tasks: TaskMesh
    nodes: TaskMesh

    @property
    def shape(self) -> dict:
        return {AXIS: self.tasks.size, NODE_AXIS: self.nodes.size}


def task_node_mesh(n_tasks: int, n_nodes: int, device=None) -> NodeMesh:
    """A 2-D (tasks, nodes) mesh over the world, which must hold exactly
    n_tasks · n_nodes ranks: two subgroups a rank from `dist.new_group`
    (every rank makes every group, in the same order)."""
    dev = resolve_device(device)
    _ensure_world(dev)
    world = dist.get_world_size()
    if world != n_tasks * n_nodes:
        raise ValueError(f"a ({n_tasks}, {n_nodes}) mesh needs "
                         f"{n_tasks * n_nodes} ranks, the world has {world}")
    rank = dist.get_rank()
    mine = {}
    for j in range(n_nodes):                  # the task axes
        g = dist.new_group([t * n_nodes + j for t in range(n_tasks)])
        if rank % n_nodes == j:
            mine[AXIS] = g
    for t in range(n_tasks):                  # the node axes
        g = dist.new_group([t * n_nodes + j for j in range(n_nodes)])
        if rank // n_nodes == t:
            mine[NODE_AXIS] = g
    return NodeMesh(tasks=_axis(mine[AXIS], dev),
                    nodes=_axis(mine[NODE_AXIS], dev))


# ----------------------------------------------------------------- padding
def pad_tasks(net: CECNetwork, phi, n_shards: int):
    """Pad the task axis to a multiple of `n_shards`, as the reference:
    padding tasks have zero rate (no flow, no cost; a = w = 1), all-local
    data and an empty result row (edge slots) or a result parked one-hot
    on each node's first out-neighbour with destination node 0 (dense).
    Returns (net_p, phi_p, S)."""
    S = net.S
    Sp = -(-S // n_shards) * n_shards
    if Sp == S:
        return net, phi, S

    def pad(x, fill=0.0):
        tail = torch.full((Sp - S,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    net_p = dataclasses.replace(
        net, dest=pad(net.dest, 0), r=pad(net.r), a=pad(net.a, 1.0),
        w=pad(net.w, 1.0), task_type=pad(net.task_type, 0))
    if isinstance(phi, PhiSparse):
        return net_p, PhiSparse(pad(phi.data), pad(phi.local, 1.0),
                                pad(phi.result)), S
    data = pad(phi.data)
    data[S:, :, -1] = 1.0
    first_nbr = torch.argmax(net.adj.to(torch.int32), dim=1)      # [V]
    onehot = (torch.arange(net.V, device=net.device)[None]
              == first_nbr[:, None]).to(phi.result.dtype)
    result = pad(phi.result)
    result[S:] = onehot
    result[S:, 0, :] = 0.0            # dest of padded tasks = node 0
    return net_p, Phi(data, result), S


def _shard(x, mesh: TaskMesh):
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def _shard_net(net: CECNetwork, mesh: TaskMesh) -> CECNetwork:
    return dataclasses.replace(
        net, **{k: _shard(getattr(net, k), mesh)
                for k in ("dest", "r", "a", "w", "task_type")})


def _shard_phi(phi, mesh: TaskMesh):
    return type(phi)(*(_shard(getattr(phi, f.name), mesh)
                       for f in dataclasses.fields(phi)))


# ------------------------------------------------------------------- steps
def make_distributed_step(mesh: TaskMesh, variant: str = "sgp",
                          scaling: str = "adaptive", kappa: float = 0.0,
                          method: str = "dense",
                          nbrs: Optional[Neighbors] = None,
                          engine_impl: Optional[str] = None, buckets=None):
    """The standalone task-sharded step, step(net, phi, consts, sigma) ->
    (phi_new, cost of phi), on this rank's shard (`net`, `phi` hold its
    tasks): φ's flows, one all-reduce of F / G, the propose.  The drivers
    use `make_distributed_step_flows`, which carries the flows."""
    _check_impl(engine_impl)
    if method == "sparse" and nbrs is None:
        raise ValueError("method='sparse' needs nbrs=build_neighbors(adj)")

    def step(net, phi, consts, sigma):
        fl = compute_flows(net, phi, method, nbrs=nbrs, buckets=buckets)
        F, G = _all_reduce_FG(fl.F, fl.G, mesh)
        fl = dataclasses.replace(fl, F=F, G=G)
        F = gather_edges(fl.F, nbrs) if method == "sparse" else fl.F
        phi_new, _ = _sgp_propose_impl(
            net, phi, FlowsCarry(fl.t_data, fl.t_result, F, fl.G), consts,
            variant=variant, scaling=scaling, sigma=sigma, kappa=kappa,
            method=method, nbrs=nbrs, buckets=buckets)
        return phi_new, cost_of_flows(net, fl)
    return step


def make_distributed_step_flows(mesh: TaskMesh, variant: str = "sgp",
                                scaling: str = "adaptive",
                                kappa: float = 0.0, method: str = "dense",
                                nbrs: Optional[Neighbors] = None,
                                engine_impl: Optional[str] = None,
                                buckets=None, fault_plan=None):
    """The drivers' task-sharded iteration, step(net, phi, fl, consts,
    sigma) -> (phi_new, fl_new, cost_new): `sgp._sgp_step_flows_impl`
    with the mesh, whose one all-reduce couples the shards.  With a
    `fault_plan` the step takes and returns a `FaultState` too, drawing
    the iteration's faults from its generator (identically seeded on
    every rank)."""
    _check_impl(engine_impl)
    if method == "sparse" and nbrs is None:
        raise ValueError("method='sparse' needs nbrs=build_neighbors(adj)")
    opts = dict(variant=variant, scaling=scaling, kappa=kappa, method=method,
                nbrs=nbrs, buckets=buckets, mesh=mesh)

    if fault_plan is not None:
        def step_f(net, phi, fl, consts, sigma, fs):
            draws = draw_faults(fs.gen, fault_plan, net.S, net.V)
            return _sgp_step_flows_impl(net, phi, fl, consts, sigma=sigma,
                                        fault_plan=fault_plan,
                                        fault_state=fs, fault_draws=draws,
                                        **opts)
        return step_f

    def step(net, phi, fl, consts, sigma):
        return _sgp_step_flows_impl(net, phi, fl, consts, sigma=sigma,
                                    **opts)
    return step


def _check_impl(engine_impl) -> None:
    if engine_impl is not None:
        raise ValueError("engine_impl must be None: the port picks each "
                         "kernel by its tensors' device")


# ------------------------------------------------------------------ driver
@dataclasses.dataclass
class DistributedRunState(RunState):
    """Resumable state of `run_distributed` on this rank: a `RunState`
    of its task shard (`phi`, `flows` and the fault and guard carries
    hold its tasks; F, G, costs and σ are the whole problem's) with the
    mesh, the shard's network `net_p` (padded, this rank's tasks), the
    original task count `S` and the step's options.
    `init_distributed_state` + chunks of `run_distributed_chunk` walk
    exactly `run_distributed`'s trajectory."""
    net_p: Optional[CECNetwork] = None
    S: int = 0
    variant: str = "sgp"
    scaling: str = "adaptive"
    kappa: float = 0.0


def init_distributed_state(net: CECNetwork, phi0,
                           mesh: Optional[TaskMesh] = None,
                           variant: str = "sgp", scaling: str = "adaptive",
                           kappa: float = 0.0, min_scale: float = 0.05,
                           method: str = "dense",
                           engine_impl: Optional[str] = None,
                           bucketed: bool = False, fault_plan=None,
                           fault_rng: Optional[torch.Generator] = None,
                           guards=None) -> DistributedRunState:
    """Pad the task axis to the mesh, take this rank's shard, convert a
    dense φ⁰ to slots under method="sparse" (bucketed=True: degree
    buckets, replicated like the tiles), and evaluate φ⁰'s flows and T⁰
    (one solve, one all-reduce).  `fault_plan` / `fault_rng` (a
    generator seeded alike on every rank; default seed 0) and `guards`
    arm the fault and guard layers on the padded shard (padded rows are
    fault-transparent: all-local data passes the mass sentinel, empty
    result rows have |rsum| = 0)."""
    _check_impl(engine_impl)
    mesh = mesh if mesh is not None else task_mesh(device=net.device)
    if mesh.device.type != net.device.type:
        raise ValueError(f"the mesh computes on {mesh.device}, the network "
                         f"lies on {net.device}")
    sparse_in = isinstance(phi0, PhiSparse)
    if sparse_in and method != "sparse":
        raise ValueError("PhiSparse requires method='sparse'; convert with "
                         "sparse_to_phi for the dense and broadcast engines")
    nbrs = build_neighbors(net.adj) if method == "sparse" else None
    buckets = (build_buckets(net.adj) if bucketed and method == "sparse"
               else None)
    net_p, phi_p, S = pad_tasks(net, phi0, mesh.size)
    if method == "sparse" and not sparse_in:
        phi_p = phi_to_sparse(phi_p, nbrs)
    net_l, phi_l = _shard_net(net_p, mesh), _shard_phi(phi_p, mesh)
    st = init_run_state(net_l, phi_l, min_scale=min_scale, method=method,
                        nbrs=nbrs, bucketed=bucketed, buckets=buckets,
                        fault_plan=fault_plan, fault_rng=fault_rng,
                        guards=guards, mesh=mesh)
    return DistributedRunState(
        **{f.name: getattr(st, f.name)
           for f in dataclasses.fields(RunState)},
        net_p=net_l, S=S, variant=variant, scaling=scaling, kappa=kappa)


def rebaseline_distributed_state(state: DistributedRunState,
                                 net: CECNetwork, phi_sp,
                                 fault_rng: Optional[torch.Generator] = None
                                 ) -> DistributedRunState:
    """Swap a SAME-GRAPH network (rate churn, a destination re-draw) and
    its repaired whole iterate `phi_sp` into the state: the fresh
    `init_distributed_state` of them (flows, T⁰, the Eq. 16 constants,
    σ = 1 and the counts reset), keeping the iteration count and the
    guard log.  `net.adj` must be the adjacency the state was built
    from; topology events rebuild the state.
    `fault_rng` re-keys the fault injector for the new segment (None
    continues the previous segment's generator); the guard carry is
    re-anchored at T⁰."""
    fresh = init_distributed_state(
        net, phi_sp, mesh=state.mesh, variant=state.variant,
        scaling=state.scaling, kappa=state.kappa, min_scale=state.min_scale,
        method=state.method, bucketed=state.buckets is not None,
        fault_plan=state.fault_plan,
        fault_rng=(fault_rng if fault_rng is not None or
                   state.fault_state is None else state.fault_state.gen),
        guards=state.guard_cfg)
    for f in ("phi", "flows", "consts", "costs", "fault_state",
              "guard_state", "net_p", "S", "sigma", "n_rejected",
              "stopped"):
        setattr(state, f, getattr(fresh, f))
    return state


def run_distributed_chunk(state: DistributedRunState, n_iters: int,
                          tol: float = 0.0, driver: Optional[str] = None
                          ) -> DistributedRunState:
    """Advance the distributed driver `n_iters` iterations in place:
    `sgp.run_chunk` on this rank's shard with the mesh in the step.
    driver="fused" (default) or "host", bit for bit alike; a fault plan
    or guards run the fused driver.  A stopped state stays stopped until
    re-baselined; `tol` fires after an accepted step."""
    if driver is None:
        driver = "fused"
    if driver not in ("host", "fused"):
        raise ValueError(f"unknown driver {driver!r}")
    if state.fault_plan is not None or state.guard_cfg is not None:
        driver = "fused"
    if driver == "fused" and not state.mesh.captures:
        raise ValueError(
            f"the fused driver captures the all-reduce in a CUDA graph: a "
            f"{state.mesh.backend} mesh on the card cannot be captured; "
            "use an NCCL mesh, or driver='host'")
    if state.stopped or n_iters <= 0:
        return state
    run_chunk(state.net_p, state, n_iters, variant=state.variant,
              scaling=state.scaling, kappa=state.kappa, tol=tol,
              refresh_every=0, driver=driver)
    return state


def _gather_tasks(x: torch.Tensor, mesh: TaskMesh) -> torch.Tensor:
    return x if mesh.size == 1 else torch.cat(mesh.all_gather(x))


def unpad_phi(state: DistributedRunState):
    """The whole current iterate, restricted to the original task count:
    the shards gathered over the mesh (a collective: every rank calls
    it)."""
    phi = state.phi
    return type(phi)(*(_gather_tasks(getattr(phi, f.name),
                                     state.mesh)[:state.S]
                       for f in dataclasses.fields(phi)))


def run_distributed(net: CECNetwork, phi0, n_iters: int = 200,
                    mesh: Optional[TaskMesh] = None, variant: str = "sgp",
                    scaling: str = "adaptive", kappa: float = 0.0,
                    min_scale: float = 0.05, method: str = "dense",
                    tol: float = 0.0, engine_impl: Optional[str] = None,
                    driver: Optional[str] = None, bucketed: bool = False,
                    fault_plan=None,
                    fault_rng: Optional[torch.Generator] = None,
                    guards=None):
    """Algorithm 1 sharded over the mesh's ranks (`task_mesh()` by
    default: the world, or a world of one), with `run`'s safeguard.
    Every rank calls it with the whole network and φ⁰; method="sparse"
    iterates the edge-slot layout (a dense φ⁰ converted at the
    boundary, and converted back).  driver="fused" (default) or "host";
    bucketed=True runs every recursion over degree buckets;
    fault_plan / fault_rng / guards as `run` (either one runs the fused
    driver; the history then also carries "guard_events" /
    "n_corrupt").  At a world of one the run is bit for bit `run`'s.
    Returns (phi_final, {"costs", "final_cost", "n_rejected"}), φ
    gathered over the ranks, in the layout it came in."""
    sparse_in = isinstance(phi0, PhiSparse)
    state = init_distributed_state(net, phi0, mesh=mesh, variant=variant,
                                   scaling=scaling, kappa=kappa,
                                   min_scale=min_scale, method=method,
                                   engine_impl=engine_impl,
                                   bucketed=bucketed, fault_plan=fault_plan,
                                   fault_rng=fault_rng, guards=guards)
    state = run_distributed_chunk(state, n_iters, tol=tol, driver=driver)
    phi = unpad_phi(state)
    if method == "sparse" and not sparse_in:
        phi = sparse_to_phi(phi, state.nbrs, net.V)
    hist = {"costs": state.costs, "final_cost": state.costs[-1],
            "n_rejected": state.n_rejected}
    if guards is not None:
        hist["guard_events"] = state.guard_events
    if state.fault_state is not None:
        hist["n_corrupt"] = int(state.fault_state.n_corrupt)
    return phi, hist


# ----------------------------------------------------------- node sharding
@dataclasses.dataclass(frozen=True)
class NodePartition:
    """The contiguous-block halo plan for sharding the NODE axis of the
    edge-slot recursions over `n` ranks (numpy, adjacency-derived).

    Nodes are split into `n` blocks of `Vl = Vp / n` rows (V zero-padded
    to Vp: padded rows have empty neighbour lists and never change).  A
    row is a BOUNDARY row of its block if a row of another block names
    it in its in- or out-neighbour list; only those rows travel in the
    per-round `all_gather`.  The per-block tables (leading axis `n`)
    remap every neighbour index into the block-local concat space
    [x_local (Vl) ; halo (n·Bmax)], the halo being every block's
    boundary rows gathered in rank order."""
    n: int                  # node shards
    V: int                  # original node count
    Vp: int                 # padded node count (n * Vl)
    Bmax: int               # max boundary rows a block
    bnd: np.ndarray         # [n, Bmax] block-local boundary row indices
    in_remap: np.ndarray    # [n, Vl, Din]  in_nbr -> concat space
    in_slot: np.ndarray     # [n, Vl, Din]  source-row slot (unchanged)
    in_mask: np.ndarray     # [n, Vl, Din]
    out_remap: np.ndarray   # [n, Vl, Dout] out_nbr -> concat space
    out_mask: np.ndarray    # [n, Vl, Dout]

    @property
    def Vl(self) -> int:
        return self.Vp // self.n


def build_node_partition(nbrs: Neighbors, n_shards: int) -> NodePartition:
    """The contiguous-block halo plan from the padded neighbour lists
    (pure numpy), table for table the reference's."""
    V = nbrs.V
    in_nbr = nbrs.in_nbr.cpu().numpy()
    in_slot = nbrs.in_slot.cpu().numpy()
    in_mask = nbrs.in_mask.cpu().numpy()
    out_nbr = nbrs.out_nbr.cpu().numpy()
    out_mask = nbrs.out_mask.cpu().numpy()
    Vl = -(-V // n_shards)
    Vp = Vl * n_shards

    def pad_rows(x, fill):
        return np.pad(x, [(0, Vp - V)] + [(0, 0)] * (x.ndim - 1),
                      constant_values=fill)

    in_nbr = pad_rows(in_nbr, 0)
    in_slot = pad_rows(in_slot, 0)
    in_mask = pad_rows(in_mask, False)
    out_nbr = pad_rows(out_nbr, 0)
    out_mask = pad_rows(out_mask, False)
    owner = np.arange(Vp) // Vl

    # boundary rows: named (through either direction's lists) by a row
    # another block owns
    boundary = [set() for _ in range(n_shards)]
    for nbr, mask in ((in_nbr, in_mask), (out_nbr, out_mask)):
        src = np.repeat(np.arange(Vp), nbr.shape[1]).reshape(nbr.shape)
        cross = mask & (owner[src] != owner[nbr])
        for u in np.unique(nbr[cross]):
            boundary[owner[u]].add(int(u))
    bnd_lists = [sorted(b) for b in boundary]
    Bmax = max(max((len(b) for b in bnd_lists), default=0), 1)
    bnd = np.zeros((n_shards, Bmax), np.int32)
    pos = np.zeros(Vp, np.int64)     # boundary position of each row
    for s, rows in enumerate(bnd_lists):
        for p, u in enumerate(rows):
            bnd[s, p] = u - s * Vl
            pos[u] = p

    def remap(nbr, mask):
        # local reads -> [0, Vl); remote -> Vl + owner·Bmax + pos
        src_owner = owner[:, None]
        tgt_owner = owner[nbr]
        r = np.where(tgt_owner == src_owner, nbr - tgt_owner * Vl,
                     Vl + tgt_owner * Bmax + pos[nbr])
        r = np.where(mask, r, 0).astype(np.int32)
        return r.reshape(n_shards, Vl, nbr.shape[1])

    def shard3(x):
        return x.reshape(n_shards, Vl, x.shape[1])
    return NodePartition(
        n=n_shards, V=V, Vp=Vp, Bmax=Bmax, bnd=bnd,
        in_remap=remap(in_nbr, in_mask),
        in_slot=shard3(in_slot).astype(np.int32),
        in_mask=shard3(in_mask),
        out_remap=remap(out_nbr, out_mask),
        out_mask=shard3(out_mask))


def _halo_gather(x: torch.Tensor, bnd: torch.Tensor, axis: int,
                 nodes: TaskMesh) -> torch.Tensor:
    """x with every block's boundary rows (along `axis`) appended, in
    rank order: the concat space the remap tables index."""
    halo = nodes.all_gather(x.index_select(axis, bnd))
    return torch.cat([x] + halo, dim=axis)


def _halo_fixed_point(w_loc, inject, remap, bnd, max_rounds: int,
                      nodes: TaskMesh):
    """The node-sharded linear fixed point x = inject + Σ_e w·x[nbr] on
    this block: a round gathers ONLY the boundary rows, reads through
    the concat-space remap and folds each local row with the plain
    `fold_reduce`, so every local row folds the same width, weights and
    neighbour states as the unsharded solve (bit for bit its rows).  The
    stop flag is all-reduced over the node axis: every block keeps
    stepping until the whole state settles."""
    def step(x):
        xc = _halo_gather(x, bnd, x.dim() - 1, nodes)
        return inject + fold_reduce(w_loc * xc[..., remap], "sum")

    def changed(a, b):
        flag = torch.any(a != b).to(torch.int32).reshape(1)
        return bool(nodes.all_reduce_(flag, dist.ReduceOp.MAX).item())

    x_prev, x, k = inject, step(inject), 1
    while k < max_rounds and changed(x, x_prev):
        x_prev, x, k = x, step(x), k + 1
    return x


def node_flows_carry_and_cost(net: CECNetwork, phi_sp: PhiSparse,
                              nbrs: Neighbors, mesh: NodeMesh,
                              part: Optional[NodePartition] = None):
    """`flows_carry_and_cost(method="sparse")` over a (tasks × nodes)
    mesh: the measurement with both axes sharded.  Every rank passes the
    whole network and iterate and computes its (task block, node block):
    the traffic rounds exchange boundary rows over the node axis (one
    gather of φ's boundary tiles a solve builds the in-edge weights),
    F / G are all-reduced over the task axis and the cost over the node
    axis.  Returns the whole (FlowsCarry, cost), gathered over both
    axes: t_data / t_result bit for bit the unsharded solve's, F and the
    cost up to cross-shard summation order."""
    n_nodes, n_tasks = mesh.nodes.size, mesh.tasks.size
    if part is None:
        part = build_node_partition(nbrs, n_nodes)
    if part.n != n_nodes:
        raise ValueError(f"partition built for {part.n} node shards, mesh "
                         f"has {n_nodes}")
    if net.S % n_tasks:
        raise ValueError(f"S={net.S} does not split over {n_tasks} task "
                         "shards")
    Vp, V, Vl = part.Vp, part.V, part.Vl
    dev = net.device

    def pad_nodes(x, axis, fill=0.0):
        widths = [0, 0] * x.dim()
        widths[2 * (x.dim() - 1 - axis) + 1] = Vp - V
        return torch.nn.functional.pad(x, widths, value=fill)

    Sl = net.S // n_tasks
    ts = slice(mesh.tasks.rank * Sl, (mesh.tasks.rank + 1) * Sl)
    ns = slice(mesh.nodes.rank * Vl, (mesh.nodes.rank + 1) * Vl)
    phi_d, phi_loc, phi_r = _phi_edge_views(phi_sp, nbrs)
    phi_d = pad_nodes(phi_d[ts], 1)[:, ns]
    phi_r = pad_nodes(phi_r[ts], 1)[:, ns]
    phi_loc = pad_nodes(phi_loc[ts], 1)[:, ns]
    r = pad_nodes(net.r[ts], 1)[:, ns]
    w = pad_nodes(net.w[ts], 1)[:, ns]
    a = net.a[ts]
    # padded rows: unit capacity, zero workload -> exactly zero cost
    link_p = pad_nodes(gather_edges(net.link_cost.params, nbrs), 0)[ns]
    comp_p = pad_nodes(net.comp_cost.params, 0, fill=1.0)[ns]
    b = mesh.nodes.rank

    def table(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x[b]), device=dev).to(dtype)
    bnd = table(part.bnd)
    in_remap, in_slot = table(part.in_remap), table(part.in_slot)
    in_mask = table(part.in_mask, torch.bool)
    out_mask = table(part.out_mask, torch.bool)

    def in_view(phi_e):
        # the in-edge weights: one boundary-row gather of φ's tiles
        pc = _halo_gather(phi_e, bnd, 1, mesh.nodes)
        return torch.where(in_mask[None], pc[:, in_remap, in_slot], 0.0)

    t_data = _halo_fixed_point(in_view(phi_d), r, in_remap, bnd, nbrs.V,
                               mesh.nodes)
    g = t_data * phi_loc
    t_result = _halo_fixed_point(in_view(phi_r), a[:, None] * g, in_remap,
                                 bnd, nbrs.V, mesh.nodes)
    F = torch.sum(t_data[..., None] * phi_d + t_result[..., None] * phi_r,
                  dim=0)
    G = torch.sum(w * g, dim=0)
    buf = mesh.tasks.all_reduce_(torch.cat([F.reshape(-1), G]))
    F, G = buf[:F.numel()].reshape(F.shape), buf[F.numel():]
    link = torch.where(out_mask, Cost(net.link_cost.family,
                                      link_p).value(F), 0.0)
    cost = torch.sum(link) + torch.sum(Cost(net.comp_cost.family,
                                            comp_p).value(G))
    cost = mesh.nodes.all_reduce_(cost.reshape(1))[0]

    def whole(x, node_axis):
        x = torch.cat(mesh.nodes.all_gather(x), dim=node_axis)
        if node_axis == 1:
            x = torch.cat(mesh.tasks.all_gather(x), dim=0)
        return x.narrow(node_axis, 0, V)
    return FlowsCarry(whole(t_data, 1), whole(t_result, 1), whole(F, 0),
                      whole(G, 0)), cost
