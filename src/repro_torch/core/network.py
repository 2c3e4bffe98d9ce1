"""The CEC flow model (paper §II) on the sparse edge-slot engine.

Layout (V nodes, S tasks), as in the JAX package's `core/network.py`:

  adj        [V, V]   bool   directed edges (i -> j)
  dest       [S]      int64  destination node of each task
  r          [S, V]   f32    exogenous data input rates
  a          [S]      f32    result-size ratio of the task's type
  w          [S, V]   f32    computation weight
  task_type  [S]      int64

The iterate φ lives in the edge-slot layout `PhiSparse`, aligned to the
out-neighbour lists of `Neighbors`: `data[s, i, e]` is the fraction of
data traffic i forwards along i -> out_nbr[i, e], `local[s, i, 0]` the
fraction it computes itself, `result[s, i, e]` the result fraction.
Slots with `out_mask[i, e]` False are padding: every consumer masks them.

The traffic recursions t = r + Φᵀ t (Eq. 1-2) and the marginal
recursions ρ = b + Φ ρ (Eq. 11-12) are fixed points solved by
`kernels.ops.edge_rounds`, over the padded [V, Dmax] tiles or, with
`buckets=`, over degree-bucketed [Vb, Db] tiles (`build_buckets`) —
bitwise the same result at ΣVb·Db lanes a round instead of V·Dmax.

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


def _sparse_only(method: str) -> None:
    if method != "sparse":
        raise ValueError(f"method={method!r}: only the sparse engine is "
                         "ported")


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
    """Per-task traffic and flows; F is the dense [V, V] link flow and
    f_data/f_result are [S, V, Dmax] edge-slot arrays."""
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
    is the [V, Dmax] edge-slot total link flow (padding exactly 0)."""
    t_data: torch.Tensor    # [S, V]
    t_result: torch.Tensor  # [S, V]
    F: torch.Tensor         # [V, Dmax]
    G: torch.Tensor         # [V]


def link_cost_sparse(net: CECNetwork, nbrs: Neighbors) -> Cost:
    """The link cost with its parameters gathered onto edge slots
    (padding slots evaluate to garbage; callers mask them)."""
    return Cost(net.link_cost.family,
                gather_edges(net.link_cost.params, nbrs))


def cost_of_carry(net: CECNetwork, carry: FlowsCarry, nbrs: Neighbors):
    link = mask_slots(link_cost_sparse(net, nbrs).value(carry.F), nbrs)
    return torch.sum(link) + torch.sum(net.comp_cost.value(carry.G))


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


def flows_carry_and_cost(net: CECNetwork, phi, method: str = "sparse",
                         nbrs: Neighbors | None = None,
                         buckets: NeighborBuckets | None = None):
    """(FlowsCarry, total cost) of one iterate, all in edge-slot layout."""
    _sparse_only(method)
    nbrs = nbrs if nbrs is not None else build_neighbors(net.adj)
    t_data, t_result, _, f_data, f_result, G = _traffic(
        net, phi, nbrs, buckets)
    carry = FlowsCarry(t_data, t_result, torch.sum(f_data + f_result, dim=0),
                       G)
    return carry, cost_of_carry(net, carry, nbrs)


def compute_flows(net: CECNetwork, phi, method: str = "sparse",
                  nbrs: Neighbors | None = None,
                  buckets: NeighborBuckets | None = None) -> Flows:
    """Forward pass of the flow model on the sparse engine (F dense)."""
    _sparse_only(method)
    nbrs = nbrs if nbrs is not None else build_neighbors(net.adj)
    t_data, t_result, g, f_data, f_result, G = _traffic(
        net, phi, nbrs, buckets)
    F = scatter_edges(torch.sum(f_data + f_result, dim=0), nbrs, net.V)
    return Flows(t_data, t_result, g, F, G, f_data, f_result)


# ------------------------------------------------------------ initial φ
# above this node count spt_phi swaps Floyd-Warshall for per-destination
# Dijkstra (scipy csgraph)
DENSE_V_LIMIT = 200


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


def _spt_next_hops(net: CECNetwork, nbrs: Neighbors,
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
