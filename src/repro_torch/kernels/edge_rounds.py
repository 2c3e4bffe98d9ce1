"""Wrappers of the Hopper fixed-point kernels (`csrc/edge_rounds.cu`).

`edge_rounds_cuda` replaces the JAX package's Pallas kernel
`kernels/edge_rounds.py:edge_rounds` and `edge_rounds_bucketed_cuda`
its `edge_rounds_bucketed`.  Both run the whole early-exit loop in one
launch and agree bit for bit with their plain versions in
`kernels/ref.py` (`edge_rounds_ref`, `edge_rounds_bucketed_ref`), which
take the tensors that lie on the CPU.  K1 runs one CTA per task row;
K2 one thread-block cluster per task row, on the rank plan of
`cluster_plan` (the bucket rows cut into ranges balanced by lanes, each
lane's neighbour packed as its owner's rank and local row).  Each
wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

__all__ = ["ClusterPlan", "EdgeBuckets", "cluster_plan", "cluster_size",
           "edge_rounds_cuda", "edge_rounds_bucketed_cuda", "max_nodes"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_BYTES = 232448            # dynamic shared memory a block can use
SMS = 132                       # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 16                # CTAs a cluster may have (above 8: non-portable)
MAX_BUCKETS = 32                # csrc kMaxSegs
MIN_CLUSTER_LANES = 1024        # lanes below which a row gets no more CTAs


def max_nodes(bucketed: bool = False) -> int:
    """Largest V whose float32 state fits on chip: K1 keeps x and the
    next round (8 bytes a node) in one CTA; K2 keeps x, the next round
    and the inject (12 bytes a node) spread over a cluster of up to 16
    CTAs, beside its lanes' tiles (9 bytes a lane), which `cluster_plan`
    checks."""
    return _SMEM_BYTES // 8 if not bucketed else \
        MAX_CLUSTER * _SMEM_BYTES // 12


def k2_smem_bytes(rows_cap: int, lanes_cap: int) -> int:
    """K2's shared memory a CTA (csrc k2_smem_bytes): x, next x, inject
    and the lanes' weights and packed neighbours (4 bytes each), two
    rounds of flags, the bucket segments, and a mask byte a lane."""
    return 4 * (3 * rows_cap + 2 * lanes_cap + 2 * MAX_CLUSTER) \
        + 16 * MAX_BUCKETS + 16 + lanes_cap


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


def cluster_size(S: int, lanes: int, sms: int = SMS) -> int:
    """CTAs a task row gets, from the shapes alone: the largest power of
    two up to 8 that keeps S rows' clusters within the card's SMs and
    leaves each CTA at least MIN_CLUSTER_LANES lanes (8 at S = 16, 4 at
    S = 32 on ba_10000's 50,030 lanes).  `cluster_plan` doubles it
    while a rank's share does not fit its shared memory."""
    c = 1
    while (c < 8 and S * 2 * c <= sms
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
                f"most {_SMEM_BYTES}; about {max_nodes(True)} nodes before "
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


def _slots_per_lane(width: int) -> int:
    P = 1 if width <= 1 else 1 << (width - 1).bit_length()
    return max(P // 32, 1)


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
    int32 [S] rounds each task row ran)."""
    V, D = nbr.shape
    w, b, dt = _operands(w_sp, inject, D, "edge_rounds")
    if V > max_nodes():
        raise ValueError(
            f"edge_rounds: V={V} exceeds the {max_nodes()} nodes whose state "
            "fits one CTA's shared memory")
    if nbr.dtype != torch.int32 or mask.dtype != torch.uint8:
        raise TypeError("edge_rounds takes int32 nbr and uint8 mask tiles")
    if nbr.device != w.device or mask.device != w.device:
        raise ValueError("edge_rounds: index tiles must lie on the weights' "
                         "device")
    out, rounds = _outputs(w, reduce)
    S = w.shape[0]
    if S == 0:
        return out, rounds
    max_rounds = V if max_rounds is None else max_rounds
    b32 = torch.empty((S, V), dtype=torch.float32, device=w.device)
    err = _build.load("edge_rounds").edge_rounds_launch(
        int(reduce == "max"), _slots_per_lane(D), dt, w.data_ptr(),
        b.data_ptr(), nbr.contiguous().data_ptr(),
        mask.contiguous().data_ptr(), out.data_ptr(), rounds.data_ptr(), S,
        V, D, float(shift), int(max_rounds), b32.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream)
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
