"""The CEC flow model (paper §II): the dense, broadcast and sparse engines.

Layout (V nodes, S tasks), as in the JAX package's `core/network.py`:

  adj        [V, V]   bool   directed edges (i -> j)
  dest       [S]      int64  destination node of each task
  r          [S, V]   f32    exogenous data input rates
  a          [S]      f32    result-size ratio of the task's type
  w          [S, V]   f32    computation weight
  task_type  [S]      int64

φ comes in two layouts.  The dense `Phi` holds data [S, V, V+1] (last
column local) and result [S, V, V].  The edge-slot `PhiSparse` is
aligned to the out-neighbour lists of `Neighbors`: `data[s, i, e]` is
the fraction of data traffic i forwards along i -> out_nbr[i, e],
`local[s, i, 0]` the fraction it computes itself, `result[s, i, e]` the
result fraction.  Slots with `out_mask[i, e]` False are padding: every
consumer masks them.

The traffic recursions t = r + Φᵀ t (Eq. 1-2) and the marginal
recursions ρ = b + Φ ρ (Eq. 11-12) are solved by one of three engines
(`method=`), as in the reference:

  "dense"      one batched LU solve of the [S, V, V] systems
               (`torch.linalg.solve_ex`, no error check: no host read);
  "broadcast"  the paper's hop-by-hop rounds x <- b + contract(Φ, x) on
               dense [S, V, V] arrays, to the fixed point (early exit;
               all V rounds while a CUDA graph is captured, which equals
               it bit for bit), differentiable through the transposed
               recursion (`_SolveFPBroadcast`);
  "sparse"     `kernels.ops.edge_rounds` over the padded [V, Dmax] tiles
               or, with `buckets=`, `edge_rounds_bucketed` over degree-
               bucketed [Vb, Db] tiles (`build_buckets`), bitwise the
               same result at ΣVb·Db lanes a round instead of V·Dmax.

Every tensor lives on one device; entry points that create tensors take
`device=`, and None means the card ("cuda").
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from ..kernels.edge_rounds import EdgeBuckets
from .costs import Cost


def resolve_device(device=None) -> torch.device:
    """None means the card; the CPU only when the caller asks for it."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class CECNetwork:
    adj: torch.Tensor        # [V, V] bool
    link_cost: Cost          # params [V, V]
    comp_cost: Cost          # params [V]
    dest: torch.Tensor       # [S] int64
    r: torch.Tensor          # [S, V]
    a: torch.Tensor          # [S]
    w: torch.Tensor          # [S, V]
    task_type: torch.Tensor  # [S] int64

    @property
    def V(self) -> int:
        return self.adj.shape[0]

    @property
    def S(self) -> int:
        return self.dest.shape[0]

    @property
    def device(self) -> torch.device:
        return self.adj.device


@dataclasses.dataclass(frozen=True)
class Phi:
    """Dense layout of φ: data [S, V, V+1] (last column local), result
    [S, V, V].  Used only at the boundary (conversions, tests)."""
    data: torch.Tensor
    result: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PhiSparse:
    """Edge-slot layout of φ (module docstring)."""
    data: torch.Tensor    # [S, V, Dmax]
    local: torch.Tensor   # [S, V, 1]
    result: torch.Tensor  # [S, V, Dmax]


@dataclasses.dataclass(frozen=True)
class Neighbors:
    """Max-degree padded neighbour lists of a concrete adjacency.

    Out-edges of i sit in ascending-j order at slots e < out_deg(i);
    `in_slot[j, e]` is the slot of edge (in_nbr[j, e] -> j) in the
    sender's out-list.  Padded slots point at node 0 and are masked."""
    out_nbr: torch.Tensor   # [V, Dmax] int64
    out_mask: torch.Tensor  # [V, Dmax] bool
    in_nbr: torch.Tensor    # [V, Dmax_in] int64
    in_slot: torch.Tensor   # [V, Dmax_in] int64
    in_mask: torch.Tensor   # [V, Dmax_in] bool

    @property
    def V(self) -> int:
        return self.out_nbr.shape[0]

    @property
    def Dmax(self) -> int:
        return self.out_nbr.shape[1]


# build_neighbors / build_buckets are memoized per (adjacency, device) in
# a bounded LRU: repeat calls on one graph return the cached tiles
_NBR_CACHE: OrderedDict = OrderedDict()
_BUCKET_CACHE: OrderedDict = OrderedDict()
_CACHE_MAX = 32


def _adj_numpy(adj) -> np.ndarray:
    if isinstance(adj, torch.Tensor):
        adj = adj.cpu().numpy()
    return np.asarray(adj, dtype=bool)


def _memo(cache: OrderedDict, key, build):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    value = build()
    cache[key] = value
    while len(cache) > _CACHE_MAX:
        cache.popitem(last=False)
    return value


def _device_of(adj, device):
    if device is not None:
        return torch.device(device)
    if isinstance(adj, torch.Tensor):
        return adj.device
    return resolve_device(None)


def _pad_lists(A: np.ndarray):
    """Row-wise padded lists of the nonzeros of A: (cols [V, D], mask,
    slot of every nonzero in row-major order)."""
    V = A.shape[0]
    rows, cols = np.nonzero(A)
    deg = A.sum(axis=1)
    D = max(int(deg.max()) if V else 1, 1)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(rows.size) - start[rows]
    nbr = np.zeros((V, D), np.int64)
    mask = np.zeros((V, D), bool)
    nbr[rows, slot] = cols
    mask[rows, slot] = True
    return nbr, mask, rows, cols, slot


def build_neighbors(adj, device=None) -> Neighbors:
    """`Neighbors` of a concrete [V, V] bool adjacency (numpy, memoized)."""
    A = _adj_numpy(adj)
    dev = _device_of(adj, device)

    def build():
        V = A.shape[0]
        out_nbr, out_mask, rows, cols, slot = _pad_lists(A)
        in_nbr, in_mask, j_in, k_in, slot_in = _pad_lists(A.T)
        # slot of edge (k -> j) in k's out-list, by its row-major key
        keys = rows.astype(np.int64) * V + cols
        pos = np.searchsorted(keys, k_in.astype(np.int64) * V + j_in)
        in_slot = np.zeros_like(in_nbr)
        in_slot[j_in, slot_in] = slot[pos]
        return Neighbors(*(torch.as_tensor(t, device=dev) for t in
                           (out_nbr, out_mask, in_nbr, in_slot, in_mask)))

    return _memo(_NBR_CACHE, (A.shape[0], A.tobytes(), str(dev)), build)


@dataclasses.dataclass(frozen=True)
class NeighborBuckets:
    """`out` drives the downstream/marginal recursions and the taint
    closure; `inn` the traffic solves, with the (in_nbr, in_slot) weight
    view folded into its wsrc/wslot tiles."""
    out: EdgeBuckets
    inn: EdgeBuckets


def _pow2_widths(deg: np.ndarray, cap: int) -> np.ndarray:
    d = np.maximum(deg.astype(np.int64), 1)
    w = 2 ** np.ceil(np.log2(d)).astype(np.int64)
    return np.minimum(w, cap)


def _bucket_direction(deg, nbr_rows, slot_rows, mask_rows,
                      out_direction: bool, dev) -> EdgeBuckets:
    V, D = nbr_rows.shape
    widths = _pow2_widths(deg, D)
    tiles = {k: [] for k in ("nodes", "nbr", "wsrc", "wslot", "mask")}
    for Db in sorted(set(widths.tolist())):
        nodes = np.nonzero(widths == Db)[0]
        nbr_b = nbr_rows[nodes, :Db]
        if out_direction:
            wsrc_b = np.broadcast_to(nodes[:, None], nbr_b.shape)
            wslot_b = np.broadcast_to(np.arange(Db)[None], nbr_b.shape)
        else:
            wsrc_b = nbr_b                       # sender rows
            wslot_b = slot_rows[nodes, :Db]      # slot in sender's list
        for k, t in (("nodes", nodes), ("nbr", nbr_b), ("wsrc", wsrc_b),
                     ("wslot", wslot_b), ("mask", mask_rows[nodes, :Db])):
            tiles[k].append(t)
    return EdgeBuckets.from_tiles(**tiles, device=dev)


def build_buckets(adj, device=None) -> NeighborBuckets:
    """Degree-bucketed tiles of a concrete adjacency (memoized)."""
    A = _adj_numpy(adj)
    dev = _device_of(adj, device)

    def build():
        nbrs = build_neighbors(A, dev)
        np_ = {k: getattr(nbrs, k).cpu().numpy() for k in
               ("out_nbr", "out_mask", "in_nbr", "in_slot", "in_mask")}
        out = _bucket_direction(A.sum(axis=1), np_["out_nbr"], None,
                                np_["out_mask"], True, dev)
        inn = _bucket_direction(A.sum(axis=0), np_["in_nbr"],
                                np_["in_slot"], np_["in_mask"], False, dev)
        return NeighborBuckets(out=out, inn=inn)

    return _memo(_BUCKET_CACHE, (A.shape[0], A.tobytes(), str(dev)), build)


# ------------------------------------------------------------- slot helpers
def _row_index(nbrs: Neighbors) -> torch.Tensor:
    return torch.arange(nbrs.V, device=nbrs.out_nbr.device)[:, None]


def gather_edges(x: torch.Tensor, nbrs: Neighbors, fill=0.0) -> torch.Tensor:
    """Per-(i, j) values onto edge slots: [..., V, K] -> [..., V, Dmax]
    (K may exceed V, e.g. Phi.data's V+1 columns).  Padding reads `fill`."""
    g = x[..., _row_index(nbrs), nbrs.out_nbr]
    return torch.where(nbrs.out_mask, g, fill)


def scatter_edges(x_sp: torch.Tensor, nbrs: Neighbors, K: int):
    """Edge-slot values back to dense: [..., V, Dmax] -> [..., V, K]."""
    lead = x_sp.shape[:-2]
    xf = mask_slots(x_sp, nbrs).reshape(-1, nbrs.V, nbrs.Dmax)
    B = xf.shape[0]
    out = torch.zeros((B, nbrs.V, K), dtype=x_sp.dtype, device=x_sp.device)
    bi = torch.arange(B, device=x_sp.device)[:, None, None]
    out.index_put_((bi, _row_index(nbrs)[None], nbrs.out_nbr[None]), xf,
                   accumulate=True)
    return out.reshape(*lead, nbrs.V, K)


def mask_slots(x_sp: torch.Tensor, nbrs: Neighbors, fill=0.0):
    """Zero (or `fill`) the padding slots of an [..., V, Dmax] array."""
    return torch.where(nbrs.out_mask, x_sp, fill)


def phi_to_sparse(phi: Phi, nbrs: Neighbors) -> PhiSparse:
    return PhiSparse(data=gather_edges(phi.data, nbrs),
                     local=phi.data[..., -1:],
                     result=gather_edges(phi.result, nbrs))


def sparse_to_phi(phi_sp: PhiSparse, nbrs: Neighbors, V: int | None = None):
    V = nbrs.V if V is None else V
    data = torch.cat([scatter_edges(phi_sp.data, nbrs, V), phi_sp.local],
                     dim=-1)
    return Phi(data, scatter_edges(phi_sp.result, nbrs, V))


def as_dense_phi(phi, net: CECNetwork) -> Phi:
    """Either φ layout in the dense one."""
    if isinstance(phi, PhiSparse):
        return sparse_to_phi(phi, build_neighbors(net.adj), net.V)
    return phi


METHODS = ("dense", "broadcast", "sparse")


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")


# ------------------------------------------------------ broadcast engine
def _fixed_point(step, x0: torch.Tensor, max_rounds: int,
                 with_rounds: bool = False, full_rounds: bool | None = None):
    """Iterate x <- step(x) until it stops changing (loop-free supports
    are nilpotent) or `max_rounds` is hit (cyclic-φ guard).

    The early exit reads the device each round.  With full_rounds=True
    (the default while a CUDA graph is captured) all `max_rounds` run:
    a fixed point reproduces itself bit for bit, so the result is the
    same.  with_rounds=True also returns the rounds the early exit
    counts."""
    if full_rounds is None:
        full_rounds = x0.is_cuda and torch.cuda.is_current_stream_capturing()
    x_prev, x, k = x0, step(x0), 1
    while k < max_rounds:
        if not full_rounds and not bool(torch.any(x != x_prev)):
            break
        x_prev, x, k = x, step(x), k + 1
    return (x, k) if with_rounds else x


def _fp_broadcast(phi_nbr, b, transpose: bool, full_rounds=None):
    """x = b + contract(Φ, x) by rounds: transpose=True solves
    x_j = b_j + Σ_i φ_ij x_i (traffic, Eq. 1-2), False solves
    x_i = b_i + Σ_j φ_ij x_j (marginals, Eq. 11-12)."""
    eq = "sij,si->sj" if transpose else "sij,sj->si"

    def step(x):
        return b + torch.einsum(eq, phi_nbr, x)

    return _fixed_point(step, b, phi_nbr.shape[-1], full_rounds=full_rounds)


class _SolveFPBroadcast(torch.autograd.Function):
    """The broadcast fixed point with the reference's custom VJP: the
    adjoint of a linear fixed point is the same recursion with the
    contraction transposed, x̄ = g + contract(Φᵀ, x̄), and Φ's cotangent
    is x̄'s outer product with the primal solution."""

    @staticmethod
    def forward(ctx, phi_nbr, b, transpose):
        x = _fp_broadcast(phi_nbr, b, transpose)
        ctx.save_for_backward(phi_nbr, x)
        ctx.transpose = transpose
        return x

    @staticmethod
    def backward(ctx, g):
        phi_nbr, x = ctx.saved_tensors
        xbar = _fp_broadcast(phi_nbr, g, not ctx.transpose)
        if ctx.transpose:
            phi_bar = torch.einsum("si,sj->sij", x, xbar)
        else:
            phi_bar = torch.einsum("si,sj->sij", xbar, x)
        return phi_bar, xbar, None


def _solve_fp_broadcast(phi_nbr, b, transpose: bool):
    return _SolveFPBroadcast.apply(phi_nbr, b, transpose)


# ---------------------------------------------------------------- solves
def _solve_traffic_sparse(phi_sp, inject, nbrs: Neighbors,
                          buckets: NeighborBuckets | None = None):
    """t = inject + Φᵀ t by in-edge message passing."""
    if buckets is not None:
        return kernel_ops.edge_rounds_bucketed(
            phi_sp, inject, buckets.inn, reduce="sum", max_rounds=nbrs.V)
    phi_in = phi_sp[:, nbrs.in_nbr, nbrs.in_slot]       # [S, V, Dmax_in]
    return kernel_ops.edge_rounds(phi_in, inject, nbrs.in_nbr, nbrs.in_mask,
                                  reduce="sum", max_rounds=nbrs.V)


def solve_downstream_sparse(phi_sp, b, nbrs: Neighbors,
                            buckets: NeighborBuckets | None = None):
    """ρ = b + Φ ρ by out-edge message passing (marginal recursions)."""
    if buckets is not None:
        return kernel_ops.edge_rounds_bucketed(
            phi_sp, b, buckets.out, reduce="sum", max_rounds=nbrs.V)
    return kernel_ops.edge_rounds(phi_sp, b, nbrs.out_nbr, nbrs.out_mask,
                                  reduce="sum", max_rounds=nbrs.V)


@dataclasses.dataclass(frozen=True)
class Flows:
    """Per-task traffic and flows; F is the dense [V, V] link flow,
    f_data/f_result are [S, V, V] (dense, broadcast) or [S, V, Dmax]
    edge-slot arrays (sparse)."""
    t_data: torch.Tensor
    t_result: torch.Tensor
    g: torch.Tensor
    F: torch.Tensor
    G: torch.Tensor
    f_data: torch.Tensor
    f_result: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlowsCarry:
    """What the next driver iteration consumes of an iterate's flows; F
    is the [V, Dmax] edge-slot total link flow (padding exactly 0) under
    the sparse engine, the dense [V, V] one under the others."""
    t_data: torch.Tensor    # [S, V]
    t_result: torch.Tensor  # [S, V]
    F: torch.Tensor         # [V, Dmax]
    G: torch.Tensor         # [V]


def link_cost_sparse(net: CECNetwork, nbrs: Neighbors) -> Cost:
    """The link cost with its parameters gathered onto edge slots
    (padding slots evaluate to garbage; callers mask them)."""
    return Cost(net.link_cost.family,
                gather_edges(net.link_cost.params, nbrs))


def cost_of_carry(net: CECNetwork, carry: FlowsCarry,
                  nbrs: Neighbors | None = None):
    """The cost of a driver carry: summed over the slots with `nbrs` (the
    sparse driver's F), over the dense [V, V] F without."""
    if nbrs is None:
        link = torch.where(net.adj, net.link_cost.value(carry.F), 0.0)
    else:
        link = mask_slots(link_cost_sparse(net, nbrs).value(carry.F), nbrs)
    return torch.sum(link) + torch.sum(net.comp_cost.value(carry.G))


def cost_of_flows(net: CECNetwork, fl) -> torch.Tensor:
    """Total cost Σ D_ij(F_ij) + Σ C_i(G_i) of a dense-F `Flows`."""
    return cost_of_carry(net, fl)


def _phi_edge_views(phi, nbrs: Neighbors):
    """(phi_d_sp, phi_loc, phi_r_sp) of either φ layout, padding zeroed."""
    if isinstance(phi, PhiSparse):
        return (mask_slots(phi.data, nbrs), phi.local[..., 0],
                mask_slots(phi.result, nbrs))
    return (gather_edges(phi.data, nbrs), phi.data[..., -1],
            gather_edges(phi.result, nbrs))


def _traffic(net: CECNetwork, phi, nbrs, buckets):
    phi_d_sp, phi_loc, phi_r_sp = _phi_edge_views(phi, nbrs)
    t_data = _solve_traffic_sparse(phi_d_sp, net.r, nbrs, buckets)
    g = t_data * phi_loc
    t_result = _solve_traffic_sparse(phi_r_sp, net.a[:, None] * g, nbrs,
                                     buckets)
    f_data = t_data[..., None] * phi_d_sp          # [S, V, Dmax]
    f_result = t_result[..., None] * phi_r_sp
    G = torch.sum(net.w * g, dim=0)
    return t_data, t_result, g, f_data, f_result, G


def flows_carry(fl: "Flows") -> FlowsCarry:
    """The driver-carry slice of a `Flows` (F dense [V, V])."""
    return FlowsCarry(fl.t_data, fl.t_result, fl.F, fl.G)


def flows_carry_and_cost(net: CECNetwork, phi, method: str = "dense",
                         nbrs: Neighbors | None = None,
                         buckets: NeighborBuckets | None = None,
                         mesh=None):
    """(FlowsCarry, total cost) of one iterate.  The sparse engine stays
    in the edge-slot layout (F on the [V, Dmax] slots); the dense and
    broadcast engines carry the dense [V, V] F.  `mesh` (a
    `distributed.TaskMesh`; `net` and φ hold this rank's tasks)
    all-reduces F and G over the ranks in one collective, so the cost
    is the whole problem's; None leaves the path as it is."""
    check_method(method)
    if method != "sparse":
        fl = compute_flows(net, phi, method)
        if mesh is not None:
            F, G = _all_reduce_FG(fl.F, fl.G, mesh)
            fl = dataclasses.replace(fl, F=F, G=G)
        return flows_carry(fl), cost_of_flows(net, fl)
    nbrs = nbrs if nbrs is not None else build_neighbors(net.adj)
    t_data, t_result, _, f_data, f_result, G = _traffic(
        net, phi, nbrs, buckets)
    F = torch.sum(f_data + f_result, dim=0)
    if mesh is not None:
        F, G = _all_reduce_FG(F, G, mesh)
    carry = FlowsCarry(t_data, t_result, F, G)
    return carry, cost_of_carry(net, carry, nbrs)


def _all_reduce_FG(F, G, mesh):
    """F and G summed over the mesh's ranks: one all-reduce of the two in
    one buffer, copied back into F and G (their own allocations)."""
    buf = mesh.all_reduce_(torch.cat([F.reshape(-1), G]))
    F.copy_(buf[:F.numel()].view(F.shape))
    G.copy_(buf[F.numel():])
    return F, G


def _solve_dense(A, b):
    """x = A⁻¹ b for a batch of [S, V, V] systems by LU, with no error
    check (it would read `info` back to the host).  On the card the LU
    goes through cuSOLVER / cuBLAS, whose calls a CUDA graph can
    capture (PyTorch's default picks MAGMA for batches, which cannot be
    captured at V = 100); the choice is PyTorch's process-wide setting,
    so it is restored after the call."""
    def solve():
        return torch.linalg.solve_ex(A, b[..., None],
                                     check_errors=False)[0][..., 0]
    if not A.is_cuda:
        return solve()
    backends = torch.backends.cuda
    prev = backends.preferred_linalg_library()
    backends.preferred_linalg_library("cusolver")
    try:
        return solve()
    finally:
        backends.preferred_linalg_library(prev)


def _solve_traffic(phi_nbr, inject, method: str = "dense"):
    """t = inject + Φᵀ t for each task: phi_nbr [S, V, V], inject [S, V]."""
    if method == "dense":
        eye = torch.eye(phi_nbr.shape[-1], dtype=phi_nbr.dtype,
                        device=phi_nbr.device)
        return _solve_dense(eye[None] - phi_nbr.transpose(-1, -2), inject)
    if method == "broadcast":
        return _solve_fp_broadcast(phi_nbr, inject, True)
    raise ValueError(f"unknown method {method!r}")


def compute_flows(net: CECNetwork, phi, method: str = "dense",
                  nbrs: Neighbors | None = None,
                  buckets: NeighborBuckets | None = None) -> Flows:
    """Forward pass of the flow model (F dense [V, V]).  method="sparse"
    runs the edge-slot engine on either φ layout (f_data / f_result on
    the slots); "dense" and "broadcast" take a dense `Phi` (f_data /
    f_result [S, V, V])."""
    check_method(method)
    if isinstance(phi, PhiSparse) and method != "sparse":
        raise ValueError(f"PhiSparse requires method='sparse', got "
                         f"{method!r}; convert with sparse_to_phi for the "
                         "dense and broadcast engines")
    if method == "sparse":
        nbrs = nbrs if nbrs is not None else build_neighbors(net.adj)
        t_data, t_result, g, f_data, f_result, G = _traffic(
            net, phi, nbrs, buckets)
        F = scatter_edges(torch.sum(f_data + f_result, dim=0), nbrs, net.V)
        return Flows(t_data, t_result, g, F, G, f_data, f_result)
    adjf = net.adj.to(phi.data.dtype)
    phi_d_nbr = phi.data[..., :-1] * adjf[None]     # non-edges masked
    phi_loc = phi.data[..., -1]
    phi_r = phi.result * adjf[None]
    t_data = _solve_traffic(phi_d_nbr, net.r, method)
    g = t_data * phi_loc
    t_result = _solve_traffic(phi_r, net.a[:, None] * g, method)
    f_data = t_data[..., None] * phi_d_nbr
    f_result = t_result[..., None] * phi_r
    F = torch.sum(f_data + f_result, dim=0)
    G = torch.sum(net.w * g, dim=0)
    return Flows(t_data, t_result, g, F, G, f_data, f_result)


def total_cost(net: CECNetwork, phi, method: str = "dense",
               nbrs: Neighbors | None = None,
               buckets: NeighborBuckets | None = None) -> torch.Tensor:
    return cost_of_flows(net, compute_flows(net, phi, method, nbrs=nbrs,
                                            buckets=buckets))


# ------------------------------------------------------------ initial φ
# above this node count spt_phi swaps Floyd-Warshall for per-destination
# Dijkstra (scipy csgraph)
DENSE_V_LIMIT = 200


def uniform_phi(net: CECNetwork) -> Phi:
    """A feasible φ that is NOT loop-free (shape plumbing only): all data
    computed locally, results spread evenly over the out-edges, none at a
    task's destination."""
    V, S = net.V, net.S
    deg = net.adj.sum(dim=1)
    data = torch.zeros((S, V, V + 1), device=net.device)
    data[..., -1] = 1.0
    result = torch.where(net.adj[None],
                         1.0 / torch.clamp_min(deg, 1)[None, :, None],
                         0.0).expand(S, V, V).clone()
    result[torch.arange(S, device=net.device), net.dest, :] = 0.0
    return Phi(data, result)


def _floyd_warshall(adj: np.ndarray, weight: np.ndarray):
    """All-pairs (dist[i, j], next_hop[i, j]) under edge weights."""
    V = adj.shape[0]
    dist = np.where(adj, weight, 1e30).astype(np.float64)
    np.fill_diagonal(dist, 0.0)
    nxt = np.where(adj, np.arange(V)[None, :], -1)
    for k in range(V):
        alt = dist[:, k:k + 1] + dist[k:k + 1, :]
        better = alt < dist
        dist = np.where(better, alt, dist)
        nxt = np.where(better, nxt[:, k:k + 1], nxt)
    return dist, nxt


def _spt_next_hops(net: CECNetwork, nbrs: Neighbors | None,
                   weight: np.ndarray | None = None) -> np.ndarray:
    """Per-task next hop toward the destination: [S, V] int64, -1 where
    there is none.  Edge weights default to the marginal link cost at
    zero flow.  Small graphs share one Floyd-Warshall; larger ones run
    Dijkstra per unique destination on the reversed graph and pick
    argmin_j w_ij + dist(j, d) (the first j on ties)."""
    adj = net.adj.cpu().numpy()
    V, S = net.V, net.S
    if weight is None:
        zeros = torch.zeros((V, V), device=net.device)
        weight = net.link_cost.d1(zeros).cpu().numpy()
    dests = net.dest.cpu().numpy()
    nx_all = np.full((S, V), -1, np.int64)
    idx = np.arange(V)

    if V > DENSE_V_LIMIT:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra
        nbrs = build_neighbors(net.adj) if nbrs is None else nbrs
        out_nbr = nbrs.out_nbr.cpu().numpy()
        out_mask = nbrs.out_mask.cpu().numpy()
        w_sp = np.maximum(weight[idx[:, None], out_nbr], 1e-12)
        rows, slots = np.nonzero(out_mask)
        # reversed graph: edge j -> i carries w_ij
        rev = csr_matrix((w_sp[rows, slots], (out_nbr[rows, slots], rows)),
                         shape=(V, V))
        uniq = np.unique(dests)
        dist_to = dijkstra(rev, indices=uniq)                  # [U, V]
        for k, d in enumerate(uniq):
            cand = np.where(out_mask, w_sp + dist_to[k][out_nbr], np.inf)
            e = np.argmin(cand, axis=1)
            ok = (idx != d) & np.isfinite(cand[idx, e])
            row = np.where(ok, out_nbr[idx, e], -1)
            for s in np.nonzero(dests == d)[0]:
                nx_all[s] = row
        return nx_all

    _, nxt = _floyd_warshall(adj, weight)
    for s in range(S):
        d = int(dests[s])
        nx = nxt[:, d]
        ok = (idx != d) & (nx >= 0)
        nx_all[s] = np.where(ok, nx, -1)
    return nx_all


def spt_phi(net: CECNetwork, weight: np.ndarray | None = None) -> Phi:
    """`spt_phi_sparse` in the dense layout: data [S, V, V+1] with the
    local column one, result [S, V, V] one-hot at each next hop."""
    V, S = net.V, net.S
    nx_all = _spt_next_hops(net, None, weight)
    data = torch.zeros((S, V, V + 1), device=net.device)
    data[..., -1] = 1.0
    result = np.zeros((S, V, V), np.float32)
    s_idx, i_idx = np.nonzero(nx_all >= 0)
    result[s_idx, i_idx, nx_all[s_idx, i_idx]] = 1.0
    return Phi(data, torch.as_tensor(result, device=net.device))


def spt_result_slots(net: CECNetwork, nbrs: Neighbors,
                     weight: np.ndarray | None = None) -> torch.Tensor:
    """Shortest-path-tree result rows in the edge-slot layout: [S, V,
    Dmax] float32 with 1.0 at the slot of each node's next hop."""
    nx_all = _spt_next_hops(net, nbrs, weight)
    out_nbr = nbrs.out_nbr.cpu().numpy()
    out_mask = nbrs.out_mask.cpu().numpy()
    hit = (out_nbr[None] == nx_all[:, :, None]) \
        & out_mask[None] & (nx_all[:, :, None] >= 0)
    return torch.as_tensor(hit, device=net.device).to(torch.float32)


def spt_phi_sparse(net: CECNetwork, nbrs: Neighbors | None = None,
                   weight: np.ndarray | None = None) -> PhiSparse:
    """The paper's feasible loop-free φ⁰ in slots: all data computed
    locally, results forwarded along the shortest-path tree toward each
    task's destination."""
    nbrs = build_neighbors(net.adj) if nbrs is None else nbrs
    S, V, D = net.S, net.V, nbrs.Dmax
    dev = net.device
    return PhiSparse(data=torch.zeros((S, V, D), device=dev),
                     local=torch.ones((S, V, 1), device=dev),
                     result=spt_result_slots(net, nbrs, weight))


def offload_phi(net: CECNetwork, compute_nodes,
                weight: np.ndarray | None = None) -> Phi:
    """A feasible loop-free φ⁰ that computes only at `compute_nodes`: each
    other node forwards its data along the shortest path toward its
    nearest compute node (zero-flow marginal weights), compute nodes
    compute locally; results follow the shortest-path tree toward each
    task's destination (dense layout, Floyd-Warshall)."""
    adj = net.adj.cpu().numpy()
    V, S = net.V, net.S
    if weight is None:
        zeros = torch.zeros((V, V), device=net.device)
        weight = net.link_cost.d1(zeros).cpu().numpy()
    dist, nxt = _floyd_warshall(adj, weight)
    compute_nodes = list(compute_nodes)
    nearest = np.asarray(compute_nodes)[
        np.argmin(dist[:, compute_nodes], axis=1)]
    data = np.zeros((S, V, V + 1), np.float32)
    for i in range(V):
        if i in compute_nodes:
            data[:, i, -1] = 1.0
        else:
            h = nxt[i, nearest[i]]
            data[:, i, h if h >= 0 else -1] = 1.0
    result = np.zeros((S, V, V), np.float32)
    for s, d in enumerate(net.dest.cpu().numpy().tolist()):
        for i in range(V):
            if i != d and nxt[i, d] >= 0:
                result[s, i, nxt[i, d]] = 1.0
    return Phi(torch.as_tensor(data, device=net.device),
               torch.as_tensor(result, device=net.device))


# ------------------------------------------------- support and repair
def support_matrices(net: CECNetwork, phi, tol: float = 0.0):
    """Boolean supports [S, V, V] of data and result forwarding
    (neighbours only)."""
    phi = as_dense_phi(phi, net)
    sup_d = (phi.data[..., :-1] > tol) & net.adj[None]
    sup_r = (phi.result > tol) & net.adj[None]
    return sup_d, sup_r


def is_loop_free(net: CECNetwork, phi, tol: float = 0.0) -> torch.Tensor:
    """True (a bool tensor on the net's device) iff both supports are
    DAGs for every task: ⌈log₂V⌉ boolean squarings of the reachability,
    each a batched float32 product on the device, then the diagonal."""
    sup_d, sup_r = support_matrices(net, phi, tol)

    def has_cycle(sup):
        V = sup.shape[-1]
        reach = sup
        for _ in range(max(1, int(np.ceil(np.log2(max(V, 2)))))):
            rf = reach.to(torch.float32)
            reach = reach | (torch.bmm(rf, rf) > 0)
        return torch.diagonal(reach, dim1=-2, dim2=-1).any()

    return ~(has_cycle(sup_d) | has_cycle(sup_r))


def refeasibilize(net: CECNetwork, phi: Phi, rebuild_tasks=None) -> Phi:
    """Project a dense φ back to feasibility after a topology change
    (node failure), as the reference does: mass on removed edges is
    zeroed and rows renormalised; data rows left with no mass compute
    locally; a task whose result routing lost mass at a live node (or an
    empty row that now carries locally computed result traffic) is
    rebuilt from the new graph's shortest-path tree, as is every task
    `rebuild_tasks` ([S] bool) names; rows that were already empty and
    carry no result traffic stay empty."""
    if isinstance(phi, PhiSparse):
        raise TypeError("refeasibilize takes a dense Phi")
    adjf = net.adj.to(phi.data.dtype)
    data_nbr = phi.data[..., :-1] * adjf[None]
    data = torch.cat([data_nbr, phi.data[..., -1:]], dim=-1)
    dsum = torch.sum(data, dim=-1, keepdim=True)
    # missing mass goes to local offload
    local = data[..., -1] + torch.clamp_min(1.0 - dsum[..., 0], 0.0)
    data = torch.cat([data[..., :-1], local[..., None]], dim=-1)
    data = data / torch.clamp_min(torch.sum(data, dim=-1, keepdim=True),
                                  1e-30)

    result = phi.result * adjf[None]
    rsum = torch.sum(result, dim=-1)                     # [S, V]
    rsum_before = torch.sum(phi.result, dim=-1)          # incl. cut edges
    is_dest = (torch.arange(net.V, device=net.device)[None]
               == net.dest[:, None])
    alive = torch.any(net.adj, dim=-1)[None] | is_dest
    src = (net.r * data[..., -1] > 1e-12) & (net.a[:, None] > 0.0)
    damaged = (rsum <= 1e-12) & ((rsum_before > 1e-12) | src) \
        & ~is_dest & alive
    broken = torch.any(damaged, dim=-1)                  # [S]
    if rebuild_tasks is not None:
        broken = broken | rebuild_tasks
    spt = spt_phi(net).result
    result = result / torch.clamp_min(rsum[..., None], 1e-30)
    result = torch.where(rsum[..., None] > 1e-12, result, 0.0)
    result = torch.where(broken[:, None, None], spt, result)
    result = torch.where(is_dest[..., None], 0.0, result)
    return Phi(data, result)


# ------------------------------------------------- edge-slot repair
def sanitize_phi_sparse(phi_sp: PhiSparse, nbrs: Neighbors) -> PhiSparse:
    """On-device repair of a damaged edge-slot iterate (no topology
    change, no host read): non-finite entries and padding zeroed,
    negatives clipped, data rows renormalised with lost mass to local
    offload (an emptied row becomes all-local), surviving result rows
    renormalised and emptied ones left empty.  Not a projection: a
    feasible iterate passes through up to renormalisation."""

    def scrub(x, mask):
        x = torch.where(torch.isfinite(x), x, 0.0)
        x = torch.clamp_min(x, 0.0)
        return torch.where(mask, x, 0.0) if mask is not None else x

    data = scrub(phi_sp.data, nbrs.out_mask[None])
    local = scrub(phi_sp.local[..., 0], None)
    dsum = torch.sum(data, dim=-1) + local
    local = local + torch.clamp_min(1.0 - dsum, 0.0)
    tot = torch.clamp_min(torch.sum(data, dim=-1) + local, 1e-30)
    data = data / tot[..., None]
    local = local / tot
    result = scrub(phi_sp.result, nbrs.out_mask[None])
    rsum = torch.sum(result, dim=-1)
    result = result / torch.clamp_min(rsum[..., None], 1e-30)
    result = torch.where(rsum[..., None] > 1e-12, result, 0.0)
    return PhiSparse(data, local[..., None], result)


def _slot_remap(old: Neighbors, new: Neighbors):
    """Per-row map from the NEW out-edge slots to the OLD slot of the
    same edge (numpy, on the host): remap[i, e'] = e with
    old.out_nbr[i, e] == new.out_nbr[i, e'], and valid[i, e'] where that
    edge existed in the old layout.  Re-slots [S, V, Dmax_old] arrays
    with one gather."""
    o_nbr = old.out_nbr.cpu().numpy()
    n_nbr = new.out_nbr.cpu().numpy()
    V = o_nbr.shape[0]
    slot_of = np.full((V, V), -1, np.int64)
    ii, ee = np.nonzero(old.out_mask.cpu().numpy())
    slot_of[ii, o_nbr[ii, ee]] = ee
    remap = slot_of[np.arange(V)[:, None], n_nbr]
    valid = new.out_mask.cpu().numpy() & (remap >= 0)
    dev = new.out_nbr.device
    return (torch.as_tensor(np.maximum(remap, 0), device=dev),
            torch.as_tensor(valid, device=dev))


def _repair_rows(net: CECNetwork, data, local, result, rsum_before,
                 out_mask, rebuild_tasks, spt_sp) -> PhiSparse:
    """The repair arithmetic both `refeasibilize_sparse` variants share,
    in one order of operations (which is what makes the same-graph
    variant bit for bit the full repair): data rows renormalised with
    missing mass to local offload; a task whose result routing lost mass
    at a live node (or whose empty row now carries locally computed
    input) rebuilt from the shortest-path rows `spt_sp`, as is every
    task `rebuild_tasks` names; destination rows emptied."""
    dsum = torch.sum(data, dim=-1) + local
    # missing mass goes to local offload
    local = local + torch.clamp_min(1.0 - dsum, 0.0)
    tot = torch.clamp_min(torch.sum(data, dim=-1) + local, 1e-30)
    data = data / tot[..., None]
    local = local / tot

    rsum = torch.sum(result, dim=-1)                       # [S, V]
    if rsum_before is None:
        # on the same graph the reslot is an exact copy
        rsum_before = rsum
    is_dest = (torch.arange(net.V, device=net.device)[None]
               == net.dest[:, None])
    alive = torch.any(out_mask, dim=-1)[None] | is_dest
    src = (net.r * local > 1e-12) & (net.a[:, None] > 0.0)
    damaged = (rsum <= 1e-12) & ((rsum_before > 1e-12) | src) \
        & ~is_dest & alive
    broken = torch.any(damaged, dim=-1)                    # [S]
    if rebuild_tasks is not None:
        broken = broken | rebuild_tasks
    result = result / torch.clamp_min(rsum[..., None], 1e-30)
    result = torch.where(rsum[..., None] > 1e-12, result, 0.0)
    result = torch.where(broken[:, None, None], spt_sp, result)
    result = torch.where(is_dest[..., None], 0.0, result)
    return PhiSparse(data, local[..., None], result)


def refeasibilize_sparse(net: CECNetwork, phi_sp: PhiSparse, nbrs: Neighbors,
                         rebuild_tasks=None):
    """`refeasibilize` for edge-slot iterates after a topology change.

    `nbrs` is the `Neighbors` the iterate is aligned to (the OLD graph);
    the repaired iterate comes back aligned to `build_neighbors` of the
    new `net.adj`, with those tiles.  The reference's policy: surviving
    mass renormalised per row, missing data mass to local offload, a task
    whose result routing lost mass rebuilt entirely from the new graph's
    shortest-path tree (partial repair can close a loop), rows that were
    already empty (a node rejoining after a failure) left empty unless
    they locally compute restored input; restored edges come back as
    zero-mass slots.  `rebuild_tasks` ([S] bool) forces tasks onto the
    SPT.  Returns (phi, new_nbrs)."""
    new_nbrs = build_neighbors(net.adj)
    remap, valid = _slot_remap(nbrs, new_nbrs)
    idx_i = torch.arange(net.V, device=net.device)[:, None]

    def reslot(x_sp):
        moved = x_sp[:, idx_i, remap]                      # [S, V, Dmax_new]
        return torch.where(valid, moved, 0.0)

    data = reslot(mask_slots(phi_sp.data, nbrs))
    result_masked = mask_slots(phi_sp.result, nbrs)
    result = reslot(result_masked)
    spt_sp = spt_result_slots(net, new_nbrs)
    phi = _repair_rows(net, data, phi_sp.local[..., 0], result,
                       torch.sum(result_masked, dim=-1), new_nbrs.out_mask,
                       rebuild_tasks, spt_sp)
    return phi, new_nbrs


def refeasibilize_sparse_samegraph(net: CECNetwork, phi_sp: PhiSparse,
                                   nbrs: Neighbors, rebuild_tasks=None,
                                   spt_sp=None) -> PhiSparse:
    """`refeasibilize_sparse` on an UNCHANGED adjacency (routing churn):
    bit for bit the same repaired iterate with the re-slotting left out
    (on the same graph it is an exact copy).  `spt_sp` takes
    `spt_result_slots(net, nbrs)` computed beforehand (the host's
    per-destination Dijkstra; it depends on the adjacency, the zero-flow
    link weights and `net.dest`, not on φ); with it every operation is
    a device op with no host read, so a fused stream can take it."""
    if spt_sp is None:
        spt_sp = spt_result_slots(net, nbrs)
    return _repair_rows(net, mask_slots(phi_sp.data, nbrs),
                        phi_sp.local[..., 0], mask_slots(phi_sp.result, nbrs),
                        None, nbrs.out_mask, rebuild_tasks, spt_sp)


# ------------------------------------------------- dynamic task pool
def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1): the task pool's capacity
    ladder (`events.TaskPool`)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def pad_tasks(net: CECNetwork, S_cap: int,
              n_active: int | None = None) -> CECNetwork:
    """Pad the task axis to `S_cap` slots for a task pool, optionally
    deactivating the tail from `n_active` on.  Padded and deactivated
    rows follow the inert-slot convention: zero rate, zero result ratio,
    unit weight (the dest / task_type of deactivated rows stay, inert
    with r = a = 0), so they carry exactly zero traffic, flow and cost.
    Adjacency and costs are untouched."""
    S, V = net.S, net.V
    S_cap = int(S_cap)
    if S_cap < S:
        raise ValueError(f"S_cap={S_cap} < S={S}: cannot drop tasks")
    n_active = S if n_active is None else int(n_active)
    if not (0 <= n_active <= S):
        raise ValueError(f"n_active={n_active} outside [0, {S}]")
    dev = net.device
    r = torch.zeros((S_cap, V), dtype=net.r.dtype, device=dev)
    r[:S] = net.r
    dest = torch.zeros(S_cap, dtype=net.dest.dtype, device=dev)
    dest[:S] = net.dest
    a = torch.zeros(S_cap, dtype=net.a.dtype, device=dev)
    a[:S] = net.a
    w = torch.ones((S_cap,) + tuple(net.w.shape[1:]), dtype=net.w.dtype,
                   device=dev)
    w[:S] = net.w
    task_type = torch.zeros(S_cap, dtype=net.task_type.dtype, device=dev)
    task_type[:S] = net.task_type
    if n_active < S:
        r[n_active:S] = 0.0
        a[n_active:S] = 0.0
        w[n_active:S] = 1.0
    return dataclasses.replace(net, r=r, dest=dest, a=a, w=w,
                               task_type=task_type)


def pad_phi_sparse(phi_sp: PhiSparse, S_cap: int) -> PhiSparse:
    """Pad the task axis of an edge-slot iterate to `S_cap` rows with
    inert rows (all-local data, empty result: what `clear_task_slot`
    writes)."""
    S = phi_sp.data.shape[0]
    S_cap = int(S_cap)
    if S_cap < S:
        raise ValueError(f"S_cap={S_cap} < S={S}: cannot drop tasks")
    if S_cap == S:
        return phi_sp
    pad = S_cap - S

    def cat(x, fill):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])
    return PhiSparse(cat(phi_sp.data, 0.0), cat(phi_sp.local, 1.0),
                     cat(phi_sp.result, 0.0))


def seed_task_slot(phi_sp: PhiSparse, slot: int,
                   spt_rows: torch.Tensor) -> PhiSparse:
    """Seed one recycled task slot from the SPT: all-local data and the
    slot's `spt_result_slots` row, the φ⁰ row a cold start gives a task
    (out of place, no host read)."""
    data, local, result = (phi_sp.data.clone(), phi_sp.local.clone(),
                           phi_sp.result.clone())
    data[slot] = 0.0
    local[slot] = 1.0
    result[slot] = spt_rows[slot].to(result.dtype)
    return PhiSparse(data, local, result)


def clear_task_slot(phi_sp: PhiSparse, slot: int) -> PhiSparse:
    """Return a departed task's slot to the inert-slot convention
    (all-local data, empty result; out of place, no host read)."""
    data, local, result = (phi_sp.data.clone(), phi_sp.local.clone(),
                           phi_sp.result.clone())
    data[slot] = 0.0
    local[slot] = 1.0
    result[slot] = 0.0
    return PhiSparse(data, local, result)


def mask_inactive_slots(phi_sp: PhiSparse, active: torch.Tensor) -> PhiSparse:
    """Every inactive slot ([S] bool `active`) back to the inert-slot
    convention in one pass (device ops, no host read): a whole-iterate
    repair can write SPT rows into a slot the pool holds empty."""
    act = active[:, None, None]
    return PhiSparse(torch.where(act, phi_sp.data, 0.0),
                     torch.where(act, phi_sp.local, 1.0),
                     torch.where(act, phi_sp.result, 0.0))
