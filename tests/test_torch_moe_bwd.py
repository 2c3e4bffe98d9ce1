"""K7's backward on the tensor cores (`csrc/moe_gmm_bwd.cu`, bfloat16)
transcribed into torch on the CPU, where the CUDA kernel cannot run:

* `bwd_tile_schedule`, the kernel's persistent schedule in Python: every
  128 x 256 dx and dw tile of the active experts goes to exactly one CTA,
  none of the inactive experts', CTAs within one tile of each other,
  with both products and with either alone.
* `kernel_emulation` takes the kernel's arithmetic in its order: per
  tile of that schedule, operands zero-filled past C, D and F, depth
  blocks of 16 (one wgmma k-step) in ascending order into float32 sums,
  one cast at the store; the inactive experts' dx and dw zero.  At
  ragged shapes (E 5, C 37 and 150, D 96 / F 80 and D 80 / F 96, 3 of 5
  experts active) it is held against the plain gradient (autograd of
  `kernels.ref.moe_gmm_ref`): float32 within 1e-5 of Σ|·| (the same
  sums over |dy|, |x| and |w|), bfloat16 within one bfloat16 ulp
  (`chip_smoke.bf16_ulps`: two float32-accurate sums round at most one
  ulp apart).
* The plain gradient against `jax.vjp` of the JAX package's
  `repro.kernels.ref.moe_gmm_ref`, `active` applied by `jnp.where`, on
  the same numpy inputs (float32, rtol 1e-5).
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels import ref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

KSTEP = 16                     # the depth of one wgmma step
BM, BN = gmm_mod.BWD_TILE
CASES = [(5, 37, 96, 80), (5, 150, 96, 80), (5, 37, 80, 96),
         (5, 150, 80, 96)]
ACTIVE = np.array([True, False, True, True, False])


def _inputs(E, C, D, F, seed=0):
    rng = np.random.RandomState(seed + C + 7 * D)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    x[~ACTIVE[:E]] = 0.0         # as the MoE layer's empty experts
    return dy, x, w


def _plain_grads(dy, x, w, active):
    xs, ws = (t.detach().clone().requires_grad_() for t in (x, w))
    out = ref.moe_gmm_ref(xs, ws, active)
    return torch.autograd.grad(out, (xs, ws), dy)


def kernel_emulation(dy, x, w, active, ctas=7, need_dx=True, need_dw=True):
    """dx, dw as the kernel sums them: for each CTA's tiles in order, A
    and B of the tile zero-filled to 128 rows, 256 columns and whole
    64-deep stages, the depth in steps of 16 into a float32 sum, one
    cast to the input dtype at the store of the tile's in-bound part."""
    E, C, D = x.shape
    F = w.shape[-1]
    dx = torch.zeros_like(x) if need_dx else None
    dw = torch.zeros_like(w) if need_dw else None
    for cta in gmm_mod.bwd_tile_schedule(E, C, D, F, active.tolist(), ctas,
                                         need_dx, need_dw):
        for kind, e, r0, n0 in cta:
            if kind == "dx":     # dy[e] [C, F] · w[e]ᵀ [F, D]
                a, b, out = dy[e].float(), w[e].float().T, dx[e]
            else:                # x[e]ᵀ [D, C] · dy[e] [C, F]
                a, b, out = x[e].float().T, dy[e].float(), dw[e]
            K = a.shape[1]
            Kp = -(-K // 64) * 64
            A = torch.zeros(BM, Kp)
            B = torch.zeros(Kp, BN)
            rows = min(BM, a.shape[0] - r0)
            cols = min(BN, b.shape[1] - n0)
            A[:rows, :K] = a[r0:r0 + rows]
            B[:K, :cols] = b[:, n0:n0 + cols]
            acc = torch.zeros(BM, BN)
            for k0 in range(0, Kp, KSTEP):
                acc = acc + A[:, k0:k0 + KSTEP] @ B[k0:k0 + KSTEP]
            out[r0:r0 + rows, n0:n0 + cols] = acc[:rows, :cols].to(x.dtype)
    return dx, dw


@pytest.mark.parametrize("E,C,D,F,ctas", [(64, 80, 2048, 1024, 132),
                                          (64, 640, 1024, 2048, 132),
                                          (5, 37, 96, 80, 7),
                                          (3, 200, 40, 24, 5)])
def test_bwd_schedule_covers_every_tile_once(E, C, D, F, ctas):
    """Each dx and dw tile of the active experts goes to exactly one CTA,
    CTAs differ by at most one tile, the inactive experts get none; so
    with `need_dx` or `need_dw` alone."""
    rng = np.random.RandomState(E + C)
    for active in (None, rng.rand(E) < 0.6):
        experts = [e for e in range(E) if active is None or active[e]]
        dx = {("dx", e, r, n) for e in experts for r in range(0, C, BM)
              for n in range(0, D, BN)}
        dw = {("dw", e, r, n) for e in experts for r in range(0, D, BM)
              for n in range(0, F, BN)}
        for need_dx, need_dw in ((True, True), (True, False),
                                 (False, True)):
            plan = gmm_mod.bwd_tile_schedule(E, C, D, F, active, ctas,
                                             need_dx, need_dw)
            assert len(plan) == ctas
            tiles = [t for cta in plan for t in cta]
            want = (dx if need_dx else set()) | (dw if need_dw else set())
            assert len(tiles) == len(want) and set(tiles) == want
            sizes = [len(cta) for cta in plan]
            assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("E,C,D,F", CASES)
def test_emulation_float32_within_1e5_of_abs_sums(E, C, D, F):
    """The transcription in float32 against the plain gradient, within
    1e-5 of the same sums over absolute values; inactive experts zero."""
    dy, x, w = (torch.from_numpy(a) for a in _inputs(E, C, D, F))
    active = torch.from_numpy(ACTIVE[:E])
    got = kernel_emulation(dy, x, w, active)
    want = _plain_grads(dy, x, w, active)
    mag = _plain_grads(dy.abs(), x.abs(), w.abs(), active)
    for g, p, m in zip(got, want, mag):
        assert bool(((g - p).abs() <= 1e-5 * m).all())
        assert not g[~active].any()


@pytest.mark.parametrize("E,C,D,F", CASES)
def test_emulation_bf16_within_one_ulp(E, C, D, F):
    """bfloat16 inputs: the transcription's one cast of its float32 sums
    is within one bfloat16 ulp of the plain gradient; inactive experts
    exactly zero, and a dx-only or dw-only schedule gives the same bits."""
    dy, x, w = (torch.from_numpy(a).bfloat16() for a in _inputs(E, C, D, F))
    active = torch.from_numpy(ACTIVE[:E])
    got = kernel_emulation(dy, x, w, active)
    want = _plain_grads(dy, x, w, active)
    for g, p in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert chip_smoke.bf16_ulps(torch, g, p) <= 1.0
        assert not g[~active].any()
    dx, none = kernel_emulation(dy, x, w, active, need_dw=False)
    none2, dw = kernel_emulation(dy, x, w, active, need_dx=False)
    assert none is None and none2 is None
    assert torch.equal(dx, got[0]) and torch.equal(dw, got[1])


@functools.cache
def _jax_vjp():
    def f(x, w, dy, active):
        out, pull = jax.vjp(
            lambda a, b: jnp.where(active[:, None, None],
                                   jref.moe_gmm_ref(a, b), 0.0), x, w)
        return pull(dy)
    return jax.jit(f)


def test_plain_gradient_matches_jax_vjp():
    """The plain gradient against `jax.vjp` of the JAX package's
    `moe_gmm_ref` with `active` by `jnp.where` (float32, rtol 1e-5)."""
    E, C, D, F = CASES[1]
    dy, x, w = _inputs(E, C, D, F, seed=1)
    jx, jw = _jax_vjp()(x, w, dy, ACTIVE[:E])
    px, pw = _plain_grads(*(torch.from_numpy(a) for a in (dy, x, w)),
                          torch.from_numpy(ACTIVE[:E]))
    for got, want in ((px, jx), (pw, jw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5 * float(
                                       np.abs(want).max()))


def test_bwd_wrapper_takes_no_cpu_tensors():
    """The backward wrapper is the card's: CPU tensors raise (the plain
    gradient is autograd's, through `ops.moe_gmm`)."""
    dy, x, w = (torch.from_numpy(a).bfloat16() for a in _inputs(5, 37, 96,
                                                                80))
    with pytest.raises(TypeError):
        gmm_mod.moe_gmm_bwd_cuda(dy, x, w)
