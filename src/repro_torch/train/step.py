"""Train and serve steps (PyTorch port of the JAX package's
`train/step.py`): gradient accumulation over microbatches, straggler
renormalisation, int8 error-feedback compression, AdamW.

The train state keeps the JAX package's layout, so that checkpoints and
`convert.train_state_from_numpy` carry over leaf for leaf:
{"params": the `param_specs()` tree (layer-stacked leaves, float32
masters), "opt": {"mu", "nu", "count"}, "model_state": the
`state_specs()` tree (the MoE load EMAs, or {}), "err" (only with
grad_compression)}.  Each microbatch the step views the masters as the
model's parameters (`convert.lm_params_from_tensors`: one tensor a
layer), casts them to the dtypes the model keeps (the compute dtype for
the matrices), calls `model.loss(..., params=)` and takes the
gradients of the masters with `torch.autograd.grad`: float32, as the
JAX package's gradient of its casts.  The model's own weights are not
read, so it may be built on the "meta" device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import optim
from ..convert import lm_params_from_tensors
from ..models.module import leaves, tree_map, tree_map2
from ..optim import OptConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    n_microbatch: int = 1
    grad_compression: bool = False   # int8 error-feedback before DP reduce


def init_train_state(params, model_state, tc: TrainConfig) -> dict:
    st = {"params": params, "opt": optim.init_opt_state(params),
          "model_state": model_state}
    if tc.grad_compression:
        st["err"] = optim.init_error_state(params)
    return st


def _unflatten(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def model_dtypes(model) -> dict:
    """The dtype `model` keeps each parameter in, by name."""
    return {k: v.dtype for k, v in model.state_dict().items()}


def loss_and_grads(model, params, mstate, batch, dtypes=None):
    """The loss of `batch` under the master weights `params` (the JAX
    layout tree) -> (loss, gradients (a tree like params, in their
    dtypes), new model state, metrics).  The masters are viewed as the
    model's parameters and cast to `dtypes` (default `model_dtypes`)."""
    dtypes = model_dtypes(model) if dtypes is None else dtypes
    paths = [p for p, _ in leaves(params)]
    flat = [t.detach().requires_grad_() for _, t in leaves(params)]
    sd = lm_params_from_tensors(model.cfg, _unflatten(paths, flat),
                                check=False)
    loss, new_ms, mets = model.loss(
        mstate, batch, params={k: t.to(dtypes[k]) for k, t in sd.items()})
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, gs)]
    return (loss.detach(), _unflatten(paths, gs),
            tree_map(torch.Tensor.detach, new_ms), mets)


def build_train_step(model, tc: TrainConfig) -> Callable:
    """-> train_step(state, batch, mb_mask=None) -> (new state, metrics).

    batch: tensors on the model's run device, leaves [B, ...] (the loss's
    keys); mb_mask [n_microbatch] (1 = arrived): microbatches whose mask
    is 0 contribute nothing, the accumulated gradient is divided by the
    number that arrived, and the model state after each microbatch is
    m·new + (1 − m)·old.  Metrics: the loss's (means over microbatches),
    "grad_norm" and "lr", as 0-dim tensors."""
    dtypes = model_dtypes(model)
    n_micro = tc.n_microbatch

    def grad_fn(params, mstate, mb):
        return loss_and_grads(model, params, mstate, mb, dtypes)[1:]

    def train_step(state, batch, mb_mask: Optional[torch.Tensor] = None):
        params = state["params"]
        mstate = state["model_state"]
        if n_micro == 1:
            grads, new_ms, metrics = grad_fn(params, mstate, batch)
        else:
            def split(x):
                return x.reshape((n_micro, x.shape[0] // n_micro)
                                 + x.shape[1:])

            mbs = {k: split(v) for k, v in batch.items()}
            dev = leaves(params)[0][1].device
            mask = (torch.ones(n_micro, device=dev) if mb_mask is None
                    else mb_mask.to(dev, torch.float32))
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            new_ms, mets_l = mstate, []
            for i in range(n_micro):
                g, ms2, mets = grad_fn(params, new_ms,
                                       {k: v[i] for k, v in mbs.items()})
                m = mask[i]
                acc = tree_map2(lambda a, x: a + m * x.float(), acc, g)
                new_ms = tree_map2(lambda old, new: m * new + (1 - m) * old,
                                   new_ms, ms2)
                mets_l.append(mets)
            denom = torch.clamp_min(mask.sum(), 1.0)
            grads = tree_map(lambda g: g / denom, acc)
            metrics = {k: torch.stack([m[k] for m in mets_l]).mean()
                       for k in mets_l[0]}

        new_state = dict(state)
        if tc.grad_compression:
            grads, new_state["err"] = optim.compress_int8(grads, state["err"])
        new_params, new_opt, om = optim.adamw_update(
            tc.opt, params, grads, state["opt"])
        new_state.update(params=new_params, opt=new_opt, model_state=new_ms)
        metrics = dict(metrics)
        metrics.update(om)
        return new_state, metrics

    return train_step


def build_serve_step(model) -> Callable:
    """One batched decode step with greedy sampling: serve_step(state,
    cache, tokens [B, 1], pos [B]) -> (next tokens [B] int32, new model
    state, cache).  The model holds its weights (the JAX step takes
    them as its first argument)."""

    def serve_step(mstate, cache, tokens, pos):
        logits, new_ms, new_cache = model.decode_step(mstate, cache, tokens,
                                                      pos)
        return logits.argmax(-1).to(torch.int32), new_ms, new_cache

    return serve_step
