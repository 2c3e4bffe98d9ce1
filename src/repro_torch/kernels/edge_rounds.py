"""Wrappers of the Hopper fixed-point kernels (`csrc/edge_rounds.cu`).

`edge_rounds_cuda` replaces the JAX package's Pallas kernel
`kernels/edge_rounds.py:edge_rounds` and `edge_rounds_bucketed_cuda`
its `edge_rounds_bucketed`.  Both run the whole early-exit loop in one
launch and agree bit for bit with their plain versions in
`kernels/ref.py` (`edge_rounds_ref`, `edge_rounds_bucketed_ref`), which
take the tensors that lie on the CPU.  Both run one thread-block
cluster of CTAs per task row over distributed shared memory.  K1 splits
the padded tile's nodes evenly (`k1_plan`: rank r owns nodes
[⌈rV/c⌉, ⌈(r+1)V/c⌉), found on the device by arithmetic); K2 cuts the
bucket rows by lanes on the host (`cluster_plan`: each lane's neighbour
packed as its owner's rank and local row).  Each wrapper counts its
launches in `.launches`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

__all__ = ["ClusterPlan", "EdgeBuckets", "K1Plan", "cluster_plan",
           "cluster_size", "edge_rounds_cuda", "edge_rounds_bucketed_cuda",
           "k1_plan", "max_nodes"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_BYTES = 232448            # dynamic shared memory a block can use
SMS = 132                       # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 16                # CTAs a cluster may have (above 8: non-portable)
MAX_BUCKETS = 32                # csrc kMaxSegs
MIN_CLUSTER_LANES = 1024        # lanes below which a row gets no more CTAs
K1_CTAS_PER_SM = 2              # K1 clusters fill up to this many CTAs an SM
K1_CLUSTER = 2                  # and give a task row at most this many CTAs
K1_SLOTS = 8                    # slots a lane folds on K1 tiles narrower than
K1_SLOTS_SHARED = 4             # 32, alone on an SM / two CTAs to an SM


def max_nodes() -> int:
    """Largest V whose float32 state fits on chip, about: K1 and K2 keep
    x, the next round and the inject (12 bytes a node) spread over a
    cluster of up to 16 CTAs, beside their lanes' tiles (9 bytes a lane)
    where those fit, which `k1_plan` and `cluster_plan` check exactly."""
    return MAX_CLUSTER * _SMEM_BYTES // 12


def k1_smem_bytes(rows_cap: int, D: int, tiles: bool) -> int:
    """K1's shared memory a CTA (csrc k1_smem_bytes): x, next x and
    inject, two rounds of flags, and with `tiles` the lanes' weights and
    packed neighbours (4 bytes each) and a mask byte a lane."""
    lanes = rows_cap * D if tiles else 0
    return 4 * (3 * rows_cap + 2 * lanes + 2 * MAX_CLUSTER) + lanes


def k2_smem_bytes(rows_cap: int, lanes_cap: int) -> int:
    """K2's shared memory a CTA (csrc k2_smem_bytes): x, next x, inject
    and the lanes' weights and packed neighbours (4 bytes each), two
    rounds of flags, the bucket segments, and a mask byte a lane."""
    return 4 * (3 * rows_cap + 2 * lanes_cap + 2 * MAX_CLUSTER) \
        + 16 * MAX_BUCKETS + 16 + lanes_cap


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """K1's split of a padded [V, D] tile over a cluster of `size` CTAs:
    rank r owns nodes [⌈rV/size⌉, ⌈(r+1)V/size⌉) (at most `rows_cap`, a
    multiple of 4) and their lanes; with `tiles` the lanes live in shared
    memory, else every round reads them from L2.  A tile narrower than 32
    is folded `slots` slots a lane: K1_SLOTS where the grid leaves each
    CTA an SM of its own, K1_SLOTS_SHARED (fewer registers) where two
    share one."""
    size: int
    rows_cap: int
    tiles: bool
    slots: int

    def smem_bytes(self, D: int) -> int:
        return k1_smem_bytes(self.rows_cap, D, self.tiles)

    def slots_a_lane(self, D: int) -> int:
        return _slots_per_lane(D, self.slots)


def k1_plan(S: int, V: int, D: int, sms: int = SMS) -> K1Plan:
    """K1's cluster from the shapes: `cluster_size` up to K1_CLUSTER CTAs
    a row and K1_CTAS_PER_SM CTAs an SM (2 at sw_1000's S = 64 and at its
    stacked S = 128), doubled up to MAX_CLUSTER while a rank's state and
    tiles do not fit its shared memory.  Where the tiles fit no cluster,
    K2's `cluster_size`, doubled while the state does not fit, with the
    tiles left in L2.  A V whose state fits no cluster is refused."""
    def rows_cap(c):
        return _round4(-(-V // c))

    for tiles, c0 in ((True, cluster_size(S, V * D, sms * K1_CTAS_PER_SM,
                                          K1_CLUSTER)),
                      (False, cluster_size(S, V * D, sms))):
        c = c0
        while k1_smem_bytes(rows_cap(c), D, tiles) > _SMEM_BYTES \
                and c < MAX_CLUSTER:
            c *= 2
        if k1_smem_bytes(rows_cap(c), D, tiles) <= _SMEM_BYTES:
            slots = K1_SLOTS if S * c <= sms else K1_SLOTS_SHARED
            return K1Plan(size=c, rows_cap=rows_cap(c), tiles=tiles,
                          slots=slots)
    raise ValueError(
        f"edge_rounds: V={V} needs {k1_smem_bytes(rows_cap(c), D, False)} "
        f"bytes of shared memory a CTA for its state even split over a "
        f"cluster of {MAX_CLUSTER} CTAs (at most {_SMEM_BYTES}; about "
        f"{max_nodes()} nodes); there is no second path")


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """K2's split of one bucket set over a cluster of `size` CTAs: rank r
    owns rows [row_start[r], row_start[r+1]) of the buckets laid end to
    end (its nodes) and their lanes [lane_start[r], lane_start[r+1]).
    `loc[q]` is lane q's neighbour as (owner rank) | (row on the owner)
    << 4; rows_cap / lanes_cap, multiples of 4, bound any rank's rows and
    lanes."""
    size: int
    row_start: torch.Tensor    # [size+1] int32
    lane_start: torch.Tensor   # [size+1] int64
    loc: torch.Tensor          # [lanes] int32
    rows_cap: int
    lanes_cap: int

    @property
    def smem_bytes(self) -> int:
        return k2_smem_bytes(self.rows_cap, self.lanes_cap)


@dataclasses.dataclass(frozen=True)
class EdgeBuckets:
    """Degree-bucketed tiles of ONE edge direction, laid end to end.

    Bucket k owns rows [row_off[k], row_off[k+1]) of `nodes` and lanes
    [lane_off[k], lane_off[k+1]) of nbr/wsrc/wslot/mask, as a
    [rows_k, widths[k]] tile in row-major order.  Row r of a bucket is
    node nodes[r]; its lanes gather the state at `nbr` (out: the head j;
    in: the tail i) and the weight at [wsrc, wslot] of the [.., V, Dmax]
    slot array.  Widths are powers of two clamped to Dmax.  `plans`
    memoizes K2's `cluster_plan` by cluster size."""
    nodes: torch.Tensor      # [V] int32
    nbr: torch.Tensor        # [lanes] int32
    wsrc: torch.Tensor       # [lanes] int32
    wslot: torch.Tensor      # [lanes] int32
    mask: torch.Tensor       # [lanes] uint8
    row_off: torch.Tensor    # [n+1] int32
    lane_off: torch.Tensor   # [n+1] int64
    width: torch.Tensor      # [n] int32
    widths: tuple            # the same widths as python ints
    lanes: int               # ΣVb·Db, the lanes of one round
    plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @classmethod
    def from_tiles(cls, nodes, nbr, wsrc, wslot, mask, device):
        """From per-bucket numpy tiles: nodes [Vb], the others [Vb, Db]."""
        widths = tuple(int(t.shape[1]) for t in nbr)
        rows = np.cumsum([0] + [t.shape[0] for t in nodes])
        lanes = np.cumsum([0] + [t.size for t in nbr])

        def flat(ts, dtype):
            return torch.as_tensor(np.concatenate([t.reshape(-1) for t in ts]),
                                   device=device).to(dtype)

        return cls(nodes=flat(nodes, torch.int32), nbr=flat(nbr, torch.int32),
                   wsrc=flat(wsrc, torch.int32),
                   wslot=flat(wslot, torch.int32),
                   mask=flat(mask, torch.uint8),
                   row_off=torch.tensor(rows, dtype=torch.int32,
                                        device=device),
                   lane_off=torch.tensor(lanes, dtype=torch.int64,
                                         device=device),
                   width=torch.tensor(widths, dtype=torch.int32,
                                      device=device),
                   widths=widths, lanes=int(lanes[-1]))


def cluster_size(S: int, lanes: int, sms: int = SMS,
                 most: int = 8) -> int:
    """CTAs a task row gets, from the shapes alone: the largest power of
    two up to `most` that keeps S rows' clusters within `sms` CTAs and
    leaves each CTA at least MIN_CLUSTER_LANES lanes (K2: 8 at S = 16,
    4 at S = 32 on ba_10000's 50,030 lanes).  `cluster_plan` doubles it
    while a rank's share does not fit its shared memory."""
    c = 1
    while (c < most and S * 2 * c <= sms
           and lanes // (2 * c) >= MIN_CLUSTER_LANES):
        c *= 2
    return c


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _plan_arrays(nodes, nbr, row_off, lane_off, widths, size: int):
    """numpy (row_start, lane_start, loc) of the split over `size` ranks:
    rank r starts at the first row whose first lane is at or past
    r·lanes/size."""
    V, lanes = nodes.size, int(lane_off[-1])
    row_lane = np.concatenate([
        lane_off[k] + np.arange(row_off[k + 1] - row_off[k]) * widths[k]
        for k in range(len(widths))] + [np.array([lanes])]).astype(np.int64)
    targets = -(-np.arange(size + 1, dtype=np.int64) * lanes // size)
    row_start = np.searchsorted(row_lane[:V], targets, side="left")
    row_start[-1] = V
    lane_start = row_lane[row_start]
    owner = np.empty(V, np.int64)
    local = np.empty(V, np.int64)
    for r in range(size):
        seg = nodes[row_start[r]:row_start[r + 1]]
        owner[seg] = r
        local[seg] = np.arange(seg.size)
    loc = owner[nbr] | (local[nbr] << 4)
    return (row_start.astype(np.int32), lane_start,
            loc.astype(np.int32))


def cluster_plan(csr: EdgeBuckets, size: int) -> ClusterPlan:
    """K2's plan of `csr` over clusters of `size` CTAs (memoized on the
    bucket set), doubled up to MAX_CLUSTER while a rank's rows and lanes
    do not fit one CTA's shared memory; beyond that it is refused."""
    plan = csr.plans.get(size)
    if plan is not None:
        return plan
    np_ = {k: getattr(csr, k).cpu().numpy()
           for k in ("nodes", "nbr", "row_off", "lane_off")}
    V = np_["nodes"].size
    if V and not (0 <= np_["nbr"].min() and np_["nbr"].max() < V):
        raise ValueError("edge_rounds_bucketed: a neighbour index is not a "
                         "node")
    c = size
    while True:
        row_start, lane_start, loc = _plan_arrays(
            np_["nodes"], np_["nbr"], np_["row_off"], np_["lane_off"],
            csr.widths, c)
        rows_cap = _round4(int(np.diff(row_start).max(initial=0)))
        lanes_cap = _round4(int(np.diff(lane_start).max(initial=0)))
        if k2_smem_bytes(rows_cap, lanes_cap) <= _SMEM_BYTES:
            break
        if c >= MAX_CLUSTER:
            raise ValueError(
                f"edge_rounds_bucketed: V={V} with {csr.lanes} lanes needs "
                f"{k2_smem_bytes(rows_cap, lanes_cap)} bytes of shared "
                f"memory a CTA even split over a cluster of {c} CTAs (at "
                f"most {_SMEM_BYTES}; about {max_nodes()} nodes before "
                "any lane); there is no second path")
        c *= 2
    dev = csr.nodes.device
    plan = ClusterPlan(
        size=c, row_start=torch.as_tensor(row_start, device=dev),
        lane_start=torch.as_tensor(lane_start, device=dev),
        loc=torch.as_tensor(loc, device=dev), rows_cap=rows_cap,
        lanes_cap=lanes_cap)
    csr.plans[size] = plan
    return plan


def _slots_per_lane(width: int, narrow: int = 1) -> int:
    """Slots a lane folds: P / 32 for a padded width P of 32 or more, else
    min(P, narrow) (K1 takes K1_SLOTS, K2 one)."""
    P = 1 if width <= 1 else 1 << (width - 1).bit_length()
    return P // 32 if P >= 32 else min(P, narrow)


def _operands(w, b, widest: int, what: str):
    if w.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors only")
    if w.dtype not in _DTYPE_CODE or b.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16 weights and "
                        f"injects, got {w.dtype} and {b.dtype}")
    if widest > 32 * 32:
        raise ValueError(f"{what}: tile width {widest} exceeds 1024")
    if w.dtype != b.dtype:           # exact: bf16 widens to f32
        w, b = w.float(), b.float()
    return w.contiguous(), b.contiguous(), _DTYPE_CODE[w.dtype]


def _outputs(w, reduce):
    if reduce not in ("sum", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    S, V, _ = w.shape
    return (torch.empty((S, V), dtype=w.dtype, device=w.device),
            torch.empty((S,), dtype=torch.int32, device=w.device))


def edge_rounds_cuda(w_sp, inject, nbr, mask, reduce: str = "sum",
                     shift: float = 0.0, max_rounds: int | None = None):
    """w_sp [S, V, Dmax], inject [S, V], nbr [V, Dmax] int32 and mask
    [V, Dmax] uint8 on the card -> (x [S, V] in the promoted dtype,
    int32 [S] rounds each task row ran).  One cluster of
    `k1_plan(S, V, Dmax).size` CTAs per task row."""
    V, D = nbr.shape
    w, b, dt = _operands(w_sp, inject, D, "edge_rounds")
    if nbr.dtype != torch.int32 or mask.dtype != torch.uint8:
        raise TypeError("edge_rounds takes int32 nbr and uint8 mask tiles")
    if nbr.device != w.device or mask.device != w.device:
        raise ValueError("edge_rounds: index tiles must lie on the weights' "
                         "device")
    out, rounds = _outputs(w, reduce)
    S = w.shape[0]
    if S == 0:
        return out, rounds
    plan = k1_plan(S, V, D)
    max_rounds = V if max_rounds is None else max_rounds
    err = _build.load("edge_rounds").edge_rounds_launch(
        int(reduce == "max"), plan.slots_a_lane(D), dt,
        w.data_ptr(), b.data_ptr(), nbr.contiguous().data_ptr(),
        mask.contiguous().data_ptr(), out.data_ptr(), rounds.data_ptr(), S,
        V, D, float(shift), int(max_rounds), plan.size, plan.rows_cap,
        int(plan.tiles), torch.cuda.current_stream(w.device).cuda_stream)
    edge_rounds_cuda.launches += 1
    _build.check(err, "edge_rounds kernel")
    return out, rounds


def edge_rounds_bucketed_cuda(w_sp, inject, csr: EdgeBuckets,
                              reduce: str = "sum", shift: float = 0.0,
                              max_rounds: int | None = None):
    """`edge_rounds_cuda` over the degree buckets of `csr`, one cluster
    of CTAs per task row; w_sp is the [S, V, Dmax] out-edge-slot weight
    array."""
    V = csr.nodes.shape[0]
    w, b, dt = _operands(w_sp, inject, max(csr.widths),
                         "edge_rounds_bucketed")
    if len(csr.widths) > MAX_BUCKETS:
        raise ValueError(f"edge_rounds_bucketed: {len(csr.widths)} buckets "
                         f"exceed {MAX_BUCKETS}")
    if csr.nodes.device != w.device:
        raise ValueError("edge_rounds_bucketed: bucket tiles must lie on "
                         "the weights' device")
    out, rounds = _outputs(w, reduce)
    S, _, D = w.shape
    if S == 0:
        return out, rounds
    plan = cluster_plan(csr, cluster_size(S, csr.lanes))
    max_rounds = V if max_rounds is None else max_rounds
    err = _build.load("edge_rounds").edge_rounds_bucketed_launch(
        int(reduce == "max"), _slots_per_lane(max(csr.widths)), dt,
        w.data_ptr(), b.data_ptr(), csr.nodes.data_ptr(),
        plan.loc.data_ptr(), csr.wsrc.data_ptr(), csr.wslot.data_ptr(),
        csr.mask.data_ptr(), csr.row_off.data_ptr(),
        csr.lane_off.data_ptr(), csr.width.data_ptr(), len(csr.widths),
        plan.row_start.data_ptr(), plan.lane_start.data_ptr(), plan.size,
        plan.rows_cap, plan.lanes_cap, out.data_ptr(), rounds.data_ptr(),
        S, V, D, float(shift), int(max_rounds),
        torch.cuda.current_stream(w.device).cuda_stream)
    edge_rounds_bucketed_cuda.launches += 1
    _build.check(err, "edge_rounds_bucketed kernel")
    return out, rounds


edge_rounds_cuda.launches = 0
edge_rounds_bucketed_cuda.launches = 0
