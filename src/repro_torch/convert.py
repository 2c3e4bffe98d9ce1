"""Carry a network and an iterate across from numpy arrays and back.

The port never sees another framework's types: a caller hands over the
fields as numpy arrays (`np.asarray(...)` of whatever holds them) and
gets numpy arrays back.  Floats become float32, index arrays int64.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.costs import Cost
from .core.network import CECNetwork, PhiSparse, resolve_device


def _f32(x, dev):
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)


def _i64(x, dev):
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)


def network_from_numpy(adj, link_params, comp_params, dest, r, a, w,
                       task_type, link_family: str, comp_family: str,
                       device=None) -> CECNetwork:
    """A `CECNetwork` on `device` (None: the card) from its fields."""
    dev = resolve_device(device)
    return CECNetwork(
        adj=torch.as_tensor(np.asarray(adj, dtype=bool), device=dev),
        link_cost=Cost(link_family, _f32(link_params, dev)),
        comp_cost=Cost(comp_family, _f32(comp_params, dev)),
        dest=_i64(dest, dev), r=_f32(r, dev), a=_f32(a, dev),
        w=_f32(w, dev), task_type=_i64(task_type, dev))


def network_to_numpy(net: CECNetwork) -> dict:
    """The fields of `net` as numpy arrays, plus the family names."""
    out = {k: getattr(net, k).cpu().numpy()
           for k in ("adj", "dest", "r", "a", "w", "task_type")}
    out["link_params"] = net.link_cost.params.cpu().numpy()
    out["comp_params"] = net.comp_cost.params.cpu().numpy()
    out["link_family"] = net.link_cost.family
    out["comp_family"] = net.comp_cost.family
    return out


def phi_sparse_from_numpy(data, local, result, device=None) -> PhiSparse:
    """An edge-slot iterate: data/result [S, V, Dmax], local [S, V, 1]."""
    dev = resolve_device(device)
    return PhiSparse(_f32(data, dev), _f32(local, dev), _f32(result, dev))


def phi_sparse_to_numpy(phi: PhiSparse) -> tuple:
    """(data, local, result) as numpy arrays."""
    return tuple(t.cpu().numpy() for t in (phi.data, phi.local, phi.result))
