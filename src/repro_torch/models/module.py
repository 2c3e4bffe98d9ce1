"""Parameter specs and their materializers (PyTorch port).

A model describes its parameters as a tree (nested dicts) of `ParamSpec`
leaves, in the JAX package's layout.  `init(specs, seed)` draws the
tree with numpy: leaf by leaf in the tree's flatten order (dict keys
sorted, as `jax.tree.flatten` orders them) from one
`np.random.RandomState(seed)`, with the JAX package's four init rules.
jax.random cannot be replayed in torch; numpy arrays can be handed to
both packages, which is how the tests and the golden run share weights.
`draw(specs, generator, device)` applies the same rules with an explicit
`torch.Generator`, each leaf drawn on the device in the dtype its model
keeps it in: the way to random weights at sizes where a numpy draw of
float64 on the host takes minutes and tens of GB.  It is not the numpy
stream, and nothing compares it to the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axis per dim
    dtype: Any = torch.float32
    init: str = "fan_in"               # fan_in | normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def leaves(tree) -> list:
    """(path, leaf) pairs in flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += [((k,) + p, v) for p, v in leaves(tree[k])]
        return out
    return [((), tree)]


def tree_map(fn, tree):
    """fn over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map2(fn, tree, *rest):
    """fn over the matching leaves of trees of one structure (the keys of
    the first)."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.int32: np.int32, torch.int64: np.int64}


def init(specs, seed: int) -> Any:
    """The spec tree drawn as numpy arrays in the JAX layout.

    zeros / ones are constant; normal is scale·N(0, 1); fan_in is
    N(0, 1)·scale/√shape[0] (for a layer-stacked leaf shape[0] is the
    layer count, as in the JAX package).  Each leaf is cast to its
    spec's dtype; a bfloat16 leaf stays float32 (numpy has no bfloat16;
    the model casts it on load)."""
    rng = np.random.RandomState(seed)

    def draw(s: ParamSpec):
        dt = _NP_DTYPES.get(s.dtype, np.float32)
        if s.init == "zeros":
            return np.zeros(s.shape, dt)
        if s.init == "ones":
            return np.ones(s.shape, dt)
        std = _std(s)
        return (std * rng.standard_normal(s.shape)).astype(dt)

    def walk(tree):     # dict keys sorted: jax.tree's flatten order
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return draw(tree)

    return walk(specs)


def _std(s: ParamSpec) -> float:
    if s.init == "normal":
        return s.scale
    if s.init == "fan_in":
        return s.scale / float(np.sqrt(max(s.shape[0] if s.shape else 1, 1)))
    raise ValueError(s.init)


def draw(specs, generator: torch.Generator, device=None,
         dtype_of=None) -> Any:
    """The spec tree drawn as tensors on `device` from `generator`, leaf
    by leaf in flatten order, with `init`'s four rules.  A leaf takes the
    dtype `dtype_of(path, spec)` (default: its spec's) and is drawn
    straight in it (`Tensor.normal_`)."""
    def one(path, s: ParamSpec):
        dt = s.dtype if dtype_of is None else dtype_of(path, s)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        return torch.empty(s.shape, dtype=dt, device=device).normal_(
            0.0, _std(s), generator=generator)

    out: dict = {}
    for path, s in leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = one(path, s)
    return out


def zeros(specs, device=None) -> Any:
    """The spec tree as zero tensors on `device` (caches)."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)


def param_count(specs) -> int:
    return int(sum(np.prod(s.shape) for _, s in leaves(specs)))
