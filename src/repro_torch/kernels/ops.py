"""Dispatch between the Hopper kernels and their plain versions.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain
PyTorch version.  `impl="ref"` forces the plain version on any device
(the tests and `chip_smoke.py`'s comparisons use it).  There is no
fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .edge_rounds import edge_rounds_bucketed_cuda, edge_rounds_cuda
from .simplex_project import simplex_project_cuda

KERNELS = (edge_rounds_cuda, edge_rounds_bucketed_cuda, simplex_project_cuda)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {"edge_rounds": edge_rounds_cuda.launches,
            "edge_rounds_bucketed": edge_rounds_bucketed_cuda.launches,
            "simplex_project": simplex_project_cuda.launches}


def _pick(impl: Optional[str], t: torch.Tensor) -> str:
    if impl == "ref":
        return "ref"
    if impl not in (None, "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if t.device.type == "cuda":
        return "cuda"
    if impl == "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors")
    return "ref"


def edge_rounds(w_sp, inject, nbr, mask, reduce: str = "sum",
                shift: float = 0.0, max_rounds: Optional[int] = None,
                impl: Optional[str] = None, return_rounds: bool = False):
    """Sparse message-passing fixed point: w_sp [S, V, Dmax] edge
    weights, inject [S, V], padded neighbour tiles nbr/mask [V, Dmax].
    Masked weight slots are ignored, so slot garbage never propagates."""
    if w_sp.shape[-2:] != nbr.shape or nbr.shape != mask.shape:
        raise ValueError(
            f"edge weights {tuple(w_sp.shape)} are not aligned to the "
            f"neighbor tiles nbr{tuple(nbr.shape)}/mask{tuple(mask.shape)}; "
            "slot arrays must share the [V, Dmax] trailing layout of their "
            "Neighbors")
    if _pick(impl, w_sp) == "ref":
        x, k = _ref.edge_rounds_ref(w_sp, inject, nbr, mask, reduce=reduce,
                                    shift=shift, max_rounds=max_rounds)
    else:
        x, k = edge_rounds_cuda(w_sp, inject, nbr.to(torch.int32),
                                mask.view(torch.uint8), reduce=reduce,
                                shift=shift, max_rounds=max_rounds)
        k = int(k.max()) if return_rounds else k
    return (x, k) if return_rounds else x


def edge_rounds_bucketed(w_sp, inject, buckets, reduce: str = "sum",
                         shift: float = 0.0,
                         max_rounds: Optional[int] = None,
                         impl: Optional[str] = None,
                         return_rounds: bool = False):
    """`edge_rounds` over degree-bucketed tiles (`edge_rounds.EdgeBuckets`):
    the same fixed point, bitwise, at ΣVb·Db lanes a round.  w_sp is
    always the [S, V, Dmax] out-edge-slot weight array."""
    if w_sp.shape[-2] != buckets.nodes.shape[0]:
        raise ValueError(
            f"edge weights {tuple(w_sp.shape)} are not aligned to the bucket "
            f"tiles (V={buckets.nodes.shape[0]}); slot arrays must share the "
            "[V, Dmax] trailing layout of the Neighbors the buckets were "
            "built from")
    if _pick(impl, w_sp) == "ref":
        x, k = _ref.edge_rounds_bucketed_ref(
            w_sp, inject, buckets, reduce=reduce, shift=shift,
            max_rounds=max_rounds)
    else:
        x, k = edge_rounds_bucketed_cuda(w_sp, inject, buckets,
                                         reduce=reduce, shift=shift,
                                         max_rounds=max_rounds)
        k = int(k.max()) if return_rounds else k
    return (x, k) if return_rounds else x


def edge_rounds_stacked(problems, nbr, mask, reduce: str = "sum",
                        shift: float = 0.0, max_rounds: Optional[int] = None,
                        impl: Optional[str] = None, buckets=None):
    """Several `edge_rounds` problems over one neighbour tiling, solved
    in ONE launch by stacking them along the task axis.  Rounds past a
    sub-problem's exact fixed point reproduce it, so this equals solving
    them one by one."""
    w = torch.cat([w for w, _ in problems], dim=0)
    b = torch.cat([inj for _, inj in problems], dim=0)
    if buckets is not None:
        out = edge_rounds_bucketed(w, b, buckets, reduce=reduce, shift=shift,
                                   max_rounds=max_rounds, impl=impl)
    else:
        out = edge_rounds(w, b, nbr, mask, reduce=reduce, shift=shift,
                          max_rounds=max_rounds, impl=impl)
    return list(torch.split(out, [w.shape[0] for w, _ in problems], dim=0))


def simplex_project(phi, delta, M, permitted, impl: Optional[str] = None):
    """Batched Eq. 15 QP rows [R, K] (no lane padding on this card)."""
    if _pick(impl, phi) == "ref":
        return _ref.simplex_project_ref(phi, delta, M, permitted)
    return simplex_project_cuda(phi, delta, M, permitted)
