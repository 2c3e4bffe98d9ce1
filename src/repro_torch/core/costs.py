"""Congestion-aware convex cost families D_ij(F) and C_i(G).

  * ``linear`` : D(F) = d * F
  * ``queue``  : D(F) = F / (cap - F), continued above SAT * cap as its
                 second-order Taylor expansion (convex, C^1, finite)
  * ``power``  : D(F) = d * F^3

Each family has value / d1 / d2 and d2_sup(T0), the sup of D'' on the
T0-sublevel set (the paper's A_ij(T0), Eq. 16).  The arithmetic follows
the JAX package's `core/costs.py` operation for operation, with integer
powers spelled as products.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

SAT = 0.95


@dataclasses.dataclass(frozen=True)
class CostFamily:
    name: str
    value: Callable   # (F, params) -> cost
    d1: Callable      # (F, params) -> first derivative
    d2: Callable      # (F, params) -> second derivative
    d2_sup: Callable  # (T0, params) -> sup of d2 on the T0-sublevel set


# ----------------------------------------------------------------- linear
def _linear_value(F, d):
    return d * F


def _linear_d1(F, d):
    return d * torch.ones_like(F)


def _linear_d2(F, d):
    return torch.zeros_like(F * d)


def _linear_d2_sup(T0, d):
    return torch.zeros_like(d, dtype=torch.float32)


LINEAR = CostFamily("linear", _linear_value, _linear_d1, _linear_d2,
                    _linear_d2_sup)


# ------------------------------------------------------------------ queue
def _queue_raw(F, cap):
    return F / (cap - F)


def _queue_raw_d1(F, cap):
    t = cap - F
    return cap / (t * t)


def _queue_raw_d2(F, cap):
    t = cap - F
    return 2.0 * cap / (t * (t * t))


def _queue_value(F, cap):
    Fs = SAT * cap
    v0 = _queue_raw(Fs, cap)
    g0 = _queue_raw_d1(Fs, cap)
    h0 = _queue_raw_d2(Fs, cap)
    dF = F - Fs
    ext = v0 + g0 * dF + 0.5 * h0 * (dF * dF)
    inner = _queue_raw(torch.minimum(F, Fs), cap)
    return torch.where(F <= Fs, inner, ext)


def _queue_d1(F, cap):
    Fs = SAT * cap
    g0 = _queue_raw_d1(Fs, cap)
    h0 = _queue_raw_d2(Fs, cap)
    inner = _queue_raw_d1(torch.minimum(F, Fs), cap)
    return torch.where(F <= Fs, inner, g0 + h0 * (F - Fs))


def _queue_d2(F, cap):
    Fs = SAT * cap
    h0 = _queue_raw_d2(Fs, cap)
    inner = _queue_raw_d2(torch.minimum(F, Fs), cap)
    return torch.where(F <= Fs, inner, h0)


def _queue_d2_sup(T0, cap):
    """D and D'' increase, so the sup sits at min(F̄, SAT·cap) with
    D(F̄) = T0, i.e. F̄ = cap·T0 / (1 + T0)."""
    Fbar = cap * T0 / (1.0 + T0)
    Fbar = torch.minimum(Fbar, SAT * cap)
    return _queue_raw_d2(Fbar, cap)


QUEUE = CostFamily("queue", _queue_value, _queue_d1, _queue_d2,
                   _queue_d2_sup)


# ------------------------------------------------------------------ power
_POWER_P = 3.0


def _power_value(F, d):
    return d * F ** _POWER_P


def _power_d1(F, d):
    return d * _POWER_P * F ** (_POWER_P - 1.0)


def _power_d2(F, d):
    return d * _POWER_P * (_POWER_P - 1.0) * F ** (_POWER_P - 2.0)


def _power_d2_sup(T0, d):
    Fbar = (T0 / torch.clamp_min(d, 1e-30)) ** (1.0 / _POWER_P)
    return _power_d2(Fbar, d)


POWER = CostFamily("power", _power_value, _power_d1, _power_d2,
                   _power_d2_sup)

FAMILIES = {"linear": LINEAR, "queue": QUEUE, "power": POWER}


@dataclasses.dataclass(frozen=True)
class Cost:
    """A family and its per-element parameters ([V, V] for links, [V]
    for compute, or [V, Dmax] gathered onto edge slots)."""
    family: str
    params: torch.Tensor

    def value(self, F):
        return FAMILIES[self.family].value(F, self.params)

    def d1(self, F):
        return FAMILIES[self.family].d1(F, self.params)

    def d2(self, F):
        return FAMILIES[self.family].d2(F, self.params)

    def d2_sup(self, T0):
        return FAMILIES[self.family].d2_sup(T0, self.params)
