"""Optimizer stack (PyTorch port of the JAX package's `optim`): AdamW
with a warmup-cosine schedule and global-norm clipping, plus int8
error-feedback gradient compression.

Plain functions on trees (nested dicts) of tensors: the optimizer state
is {"mu", "nu": trees of float32 like the parameters, "count": int32
0-dim}.  Every function returns new tensors and leaves its inputs as
they are, as the JAX functions do.  Scalars (the schedule's step, the
bias corrections, the clip scale) are float32 tensors on the leaves'
device, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.module import leaves, tree_map, tree_map2


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor): linear warmup to cfg.lr
    over warmup_steps, then a cosine decay to min_lr_frac·lr at
    decay_steps, in float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def init_opt_state(params) -> dict:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = leaves(params)[0][1].device
    return {"mu": zeros, "nu": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (float32), summed leaf by
    leaf in flatten order (dict keys sorted), as the JAX function does."""
    sq = sum(torch.sum(torch.square(x.float())) for _, x in leaves(tree))
    return torch.sqrt(sq)


def adamw_update(cfg: OptConfig, params, grads, opt_state):
    """One AdamW step -> (new params in their dtypes, new optimizer state,
    {"grad_norm", "lr"}): gradients clipped to global norm clip_norm,
    bias-corrected moments, decoupled weight decay, the update computed
    in float32."""
    count = opt_state["count"] + 1
    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
    grads = tree_map(lambda g: g.float() * scale, grads)

    lr = schedule(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, cf)
    b2c = 1 - torch.pow(cfg.b2, cf)

    mu = tree_map2(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                   opt_state["mu"], grads)
    nu = tree_map2(lambda n, g: cfg.b2 * n + (1 - cfg.b2) * g * g,
                   opt_state["nu"], grads)

    def upd(p, m, n):
        mh = m / b1c
        nh = n / b2c
        step = mh / (torch.sqrt(nh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map2(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}, \
        {"grad_norm": gn, "lr": lr}


# ------------------------------------------------------- grad compression
def compress_int8(grads, error):
    """Error-feedback int8 quantization with one scale a leaf ->
    (dequantized gradients in their dtypes, new error state): the leaf
    plus its carried error, rounded to max|·|/127 steps (half to even,
    clipped to ±127); what the rounding left is carried to the next
    step."""
    def one(g, e):
        gf = g.float() + e
        # max/127 as XLA computes it: the division by a constant folded
        # into a product with its float32 reciprocal
        scale = gf.abs().max() * _INV_127 + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        deq = q * scale
        return deq.to(g.dtype), gf - deq

    pairs = tree_map2(one, grads, error)     # a pair is a leaf here
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


_INV_127 = float(np.float32(1.0 / 127.0))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
