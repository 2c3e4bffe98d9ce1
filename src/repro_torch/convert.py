"""Carry a network, an iterate, a churn schedule and task pool, a fault
and a guard carry, a request router's and a distributed run's state, LM
weights and LM state across from numpy arrays.

The port never sees another framework's types: a caller hands over the
fields as numpy arrays (`np.asarray(...)` of whatever holds them) and
gets numpy arrays back.  Floats become float32, index arrays int64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.costs import Cost
from .core.network import (CECNetwork, FlowsCarry, Phi, PhiSparse,
                           resolve_device)


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


def phi_from_numpy(data, result, device=None) -> Phi:
    """A dense iterate: data [S, V, V+1] (last column local), result
    [S, V, V]."""
    dev = resolve_device(device)
    return Phi(_f32(data, dev), _f32(result, dev))


def phi_sparse_from_numpy(data, local, result, device=None) -> PhiSparse:
    """An edge-slot iterate: data/result [S, V, Dmax], local [S, V, 1]."""
    dev = resolve_device(device)
    return PhiSparse(_f32(data, dev), _f32(local, dev), _f32(result, dev))


def phi_sparse_to_numpy(phi: PhiSparse) -> tuple:
    """(data, local, result) as numpy arrays."""
    return tuple(t.cpu().numpy() for t in (phi.data, phi.local, phi.result))


def router_to_numpy(router) -> dict:
    """A `serving.RequestRouter`'s network fields (`network_to_numpy`),
    its live iterate as (data, local, result) under "phi" (None before
    the first plan) and its pod nodes."""
    out = network_to_numpy(router.net)
    phi = router.phi
    out["phi"] = (None if phi is None else phi_sparse_to_numpy(phi)
                  if isinstance(phi, PhiSparse)
                  else tuple(t.cpu().numpy() for t in (phi.data,
                                                       phi.result)))
    out["pod_nodes"] = list(router.pod_nodes)
    return out


def distributed_phi_to_numpy(state) -> tuple:
    """The PADDED whole iterate of a `distributed.DistributedRunState`
    (every rank's task shard gathered, padding tasks kept: the
    reference's padded global φ) as numpy arrays, field by field.  A
    collective: every rank calls it."""
    from .core.distributed import _gather_tasks
    return tuple(_gather_tasks(getattr(state.phi, f.name),
                               state.mesh).cpu().numpy()
                 for f in dataclasses.fields(state.phi))


def fault_state_from_numpy(ring, held, n_corrupt, seed: int = 0,
                           device=None):
    """A `faults.FaultState` on `device` (None: the card): `ring` and
    `held` are None or the four marginal arrays (rho_data, rho_result,
    delta_data, delta_result), stacked [k+1, ...] in the ring; the fault
    generator is seeded with `seed`."""
    from .core.faults import FaultState
    dev = resolve_device(device)

    def four(x):
        return None if x is None else tuple(_f32(a, dev) for a in x)
    return FaultState(
        gen=torch.Generator(device=dev).manual_seed(seed), ring=four(ring),
        held=four(held),
        n_corrupt=torch.tensor(int(n_corrupt), dtype=torch.int32,
                               device=dev))


def guard_state_from_numpy(ckpt_phi, ckpt_fl, ckpt_cost, ckpt_sigma, valid,
                           ptr, window, wptr, retries, n_trips,
                           device=None):
    """A `guards.GuardState` on `device` (None: the card).  `ckpt_phi` is
    the ring's stacked (data, local, result) of an edge-slot iterate, or
    (data, result) of a dense one; `ckpt_fl` the stacked (t_data,
    t_result, F, G); the counters are integers."""
    from .core.guards import GuardState
    dev = resolve_device(device)

    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32, device=dev)
    phi_cls = PhiSparse if len(ckpt_phi) == 3 else Phi
    return GuardState(
        ckpt_phi=phi_cls(*(_f32(a, dev) for a in ckpt_phi)),
        ckpt_fl=FlowsCarry(*(_f32(a, dev) for a in ckpt_fl)),
        ckpt_cost=_f32(ckpt_cost, dev), ckpt_sigma=_f32(ckpt_sigma, dev),
        valid=torch.as_tensor(np.asarray(valid, dtype=bool), device=dev),
        ptr=i32(ptr), window=_f32(window, dev), wptr=i32(wptr),
        retries=i32(retries), n_trips=i32(n_trips))


def lm_params_from_numpy(cfg, tree: dict, device=None) -> dict:
    """The port's `LM` or `EncDecLM` weights (a state dict for its
    `load_state_dict`) on `device` (None: the card) from the JAX
    package's `param_specs()` tree of the same model as numpy arrays
    (`models.module.init` draws one).

    Layout changes, from the JAX tree to the port:

    * `blocks/slot_{j}/...` leaves carry a leading `layers` axis of
      n_layers / period groups; group g of slot j becomes layer
      g·period + j (`layers.{i}.*`), one tensor per layer;
    * `mixer/wq [d, H, hd]` -> `wq [d, H·hd]`, `mixer/wk`, `mixer/wv
      [d, KV, hd]` -> `[d, KV·hd]`, `mixer/wo [H, hd, d]` -> `wo
      [H·hd, d]` (row-major reshapes: x @ wq equals the einsum
      "bld,dhk->blhk" flattened over (h, k));
    * `mixer/q_norm`, `mixer/k_norm`, `ln1`, `ln2` keep their shapes, as
      do `ffn/wg`, `ffn/wu [d, f]` and `ffn/wd [f, d]` of a dense FFN
      and `ffn/router [d, E]`, `ffn/wg`, `ffn/wu [E, d, f]` and `ffn/wd
      [E, f, d]` of a MoE FFN (the `mixer/` and `ffn/` levels are
      dropped from the names);
    * a Mamba2 mixer's leaves keep their names and shapes (`in_z`,
      `in_x`, `in_B`, `in_C`, `in_dt`, `conv_x`, `conv_B`, `conv_C`,
      `conv_bx`, `conv_bB`, `conv_bC`, `A_log`, `D`, `dt_bias`, `norm`,
      `out_proj`): no reshapes;
    * `embed [vocab, d]`, `final_norm [d]` and, untied, `unembed
      [d, vocab]` carry over as they are;
    * the encoder-decoder's tree (`cfg.family == "encdec"`) keeps its
      nesting: layer g of `enc_blocks/{ln1, mixer, ln2, ffn}` becomes
      `enc_blocks.{g}.*` and of `dec_blocks/{ln1, self_attn, lnx,
      cross_attn, ln2, ffn}` `dec_blocks.{g}.*` (e.g.
      `dec_blocks.3.cross_attn.wq`), the attention matrices reshaped as
      above; `embed`, `enc_norm`, `final_norm` and `unembed` carry over.

    Tensors come back float32; `load_state_dict` casts each to the
    dtype the model keeps it in: the compute dtype for the attention,
    MLP and expert matrices, `embed` / `unembed`, and the Mamba
    projections, conv weights and conv biases (`models.layers.mamba.
    COMPUTE_DTYPE_LEAVES`); the parameter dtype for the norm scales;
    float32 for the MoE router, `A_log`, `D` and `dt_bias`."""
    dev = resolve_device(device)
    return _state_dict(cfg, tree, lambda a: _f32(a, dev))


def lm_params_from_tensors(cfg, tree: dict) -> dict:
    """`lm_params_from_numpy` for a tree of tensors (`models.module.draw`
    draws one on the card): the same layout changes, each tensor kept in
    its dtype and on its device (layers are views of the stacked
    leaves)."""
    return _state_dict(cfg, tree, lambda a: a)


def _attn_shapes(cfg) -> dict:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    return {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
            "wo": (H * hd, d)}


def _state_dict(cfg, tree: dict, leaf) -> dict:
    from .models import build_model
    out = (_encdec_state_dict(cfg, tree, leaf) if cfg.family == "encdec"
           else _lm_state_dict(cfg, tree, leaf))
    expected = set(build_model(cfg, device="meta").state_dict())
    if set(out) != expected:
        raise ValueError(f"{cfg.name}: the tree does not match the model: "
                         f"missing {sorted(expected - set(out))}, extra "
                         f"{sorted(set(out) - expected)}")
    return out


def _encdec_state_dict(cfg, tree: dict, leaf) -> dict:
    reshape = _attn_shapes(cfg)
    out = {k: leaf(tree[k])
           for k in ("embed", "enc_norm", "final_norm", "unembed")}
    for stack in ("enc_blocks", "dec_blocks"):
        for part, sub in tree[stack].items():
            flat = sub.items() if isinstance(sub, dict) else [(None, sub)]
            for name, stacked in flat:
                for g in range(stacked.shape[0]):
                    a = stacked[g]
                    if name in reshape:
                        a = a.reshape(reshape[name])
                    key = f"{stack}.{g}.{part}"
                    out[key if name is None else f"{key}.{name}"] = leaf(a)
    return out


def _lm_state_dict(cfg, tree: dict, leaf) -> dict:
    period = cfg.scan_period()
    pattern = cfg.layer_pattern()[:period]
    reshape = _attn_shapes(cfg)
    out = {"embed": leaf(tree["embed"]),
           "final_norm": leaf(tree["final_norm"])}
    if "unembed" in tree:
        out["unembed"] = leaf(tree["unembed"])
    for j in range(len(pattern)):
        slot = tree["blocks"][f"slot_{j:02d}"]
        flat = {"ln1": slot["ln1"], **slot["mixer"]}
        if "ffn" in slot:
            flat.update(ln2=slot["ln2"], **slot["ffn"])
        for name, stacked in flat.items():
            for g in range(stacked.shape[0]):
                a = stacked[g]
                if name in reshape:
                    a = a.reshape(reshape[name])
                out[f"layers.{g * period + j}.{name}"] = leaf(a)
    return out


def lm_leaf_dtypes(model):
    """`(path, spec) -> dtype`: the dtype `model` (an `LM` or an
    `EncDecLM`) keeps each leaf of its JAX layout tree in, for
    `models.module.draw`."""
    sd = {k: v.dtype for k, v in model.state_dict().items()}

    def dtype_of(path, spec):
        if path[0] in ("enc_blocks", "dec_blocks"):   # layer 0 stands in
            return sd[".".join((path[0], "0") + path[1:])]
        if path[0] != "blocks":
            return sd[path[0]]
        return sd[f"layers.{int(path[1][len('slot_'):])}.{path[-1]}"]
    return dtype_of


def lm_state_from_numpy(cfg, tree: dict, device=None) -> dict:
    """The model state of the port's `LM` or `EncDecLM` (its
    `state_specs()` tree: the MoE load EMAs [n_groups, E], or {}) on
    `device` (None: the card) from the JAX package's `state_specs()`
    tree of the same model as numpy arrays: the same layout, float32."""
    from .models import build_model, module
    dev = resolve_device(device)
    specs = build_model(cfg, device="meta").state_specs()
    got = [(p, np.shape(a)) for p, a in module.leaves(tree)]
    want = [(p, s.shape) for p, s in module.leaves(specs)]
    if got != want:
        raise ValueError(f"{cfg.name}: the state tree {got} does not match "
                         f"the model's {want}")
    return module.tree_map(lambda a: _f32(a, dev), tree)


# ------------------------------------------------------------- churn
_EVENT_TYPES = ("RateScale", "SourceRedraw", "DestRedraw", "RateSet",
                "NodeFail", "NodeRecover", "LinkCut", "LinkRestore",
                "TaskArrive", "TaskDepart")


def event_from_numpy(type_name: str, fields: dict):
    """A port churn event from its class name in `core.events` and its
    fields (numbers, or numpy arrays for `TaskArrive.r` / `.w` and
    `RateSet.r`)."""
    from .core import events
    if type_name not in _EVENT_TYPES:
        raise ValueError(f"unknown churn event type {type_name!r}")
    cls = getattr(events, type_name)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in fields:
            v = fields[f.name]
            kw[f.name] = np.asarray(v) if isinstance(v, (list, np.ndarray)) \
                else v
    return cls(**kw)


def event_to_numpy(event) -> tuple:
    """(class name, fields) of a churn event, arrays as numpy arrays."""
    return type(event).__name__, {
        f.name: (np.asarray(getattr(event, f.name))
                 if isinstance(getattr(event, f.name), (list, np.ndarray))
                 else getattr(event, f.name))
        for f in dataclasses.fields(event)}


def schedule_from_numpy(events, name: str = ""):
    """A port `ChurnSchedule` from ((iteration, class name, fields), ...),
    e.g. a reference schedule's events through `event_to_numpy`."""
    from .core.events import ChurnSchedule
    return ChurnSchedule(tuple((int(t), event_from_numpy(k, f))
                               for t, k, f in events), name=name)


def pool_from_numpy(active, policy: str, ever_padded: bool,
                    queue=()) -> "TaskPool":
    """A port `TaskPool` from its state: the [S_cap] bool `active`, the
    admission policy, whether a slot was ever empty, and the deferred
    arrivals as (class name, fields) pairs."""
    from .core.events import TaskPool
    active = np.asarray(active, dtype=bool).copy()
    pool = TaskPool(int(active.sum()), S_cap=active.shape[0], policy=policy)
    pool.active = active
    pool.ever_padded = bool(ever_padded)
    pool.queue = [event_from_numpy(k, f) for k, f in queue]
    return pool
