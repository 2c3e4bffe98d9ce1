"""K4's backward on the tensor cores (`csrc/flash_attention_bwd.cu`, the
bfloat16 kernels at hd 64 and 128) transcribed into torch on the CPU,
where the CUDA kernel cannot run: `kernel_emulation` takes the kernel's
arithmetic in its order, and is held against the plain version's
gradient (`kernels.ref.flash_attention_ref` under autograd) and the JAX
package's.

* The transcription: D = rowsum(dO ∘ O) from the float32 output; the
  dK/dV pass a 64-key block at a time over the group's query heads and
  then the 64-query blocks (causal: at or below the diagonal), the dQ
  pass a 64-query block at a time over the key blocks; P rebuilt as
  exp2(S·scale·log2 e − lse·log2 e) from the log-sum-exp, masked
  entries 0, dS = P ∘ (dP − D); P and dS cut into bfloat16 parts (three:
  float32's 2^-25, as `split_bf16_3`) that enter the products with dO,
  Q and K 16 rows (one wgmma k-step) at a time, smallest part first,
  into float32 sums; dK and dQ times the scale at the end.
* Cases: causal on packed segments with G = 2 (S 96), causal packed at
  G = 7 and hd 128 (S 70), non-causal cross attention of 17 queries
  against 150 keys; every length past a multiple of 64 (the tail).
* float32: the transcription's gradient before its cast within
  K4_BWD_RTOL (1e-4) of each gradient's largest magnitude, as
  `chip_smoke.py` holds the float32 kernel; bfloat16: cast, no further
  from the plain bfloat16 gradient than 1.5x the witness (the plain
  version with its key and head-dim sums reversed), in bfloat16 ulps
  (`chip_smoke.witness_check`), the rule the card holds the kernel to.
* P and dS in a single bfloat16 part fail that rule on the causal
  packed case: the split matters.
* One case against `jax.grad` of the JAX package's naive attention on
  the same numpy inputs, at `test_attention_ref_grad_matches_reference`'s
  tolerance (1e-5 of each gradient's norm in L2 and of its largest
  magnitude elementwise).
"""
import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import naive_attention as jnaive
from repro_torch.kernels import ref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

BLOCK, KSTEP = 64, 16          # the kernel's blocks and its wgmma depth
LOG2E = 1.4426950408889634
K4_BWD_RTOL = chip_smoke.K4_BWD_RTOL
# (B, H, KV, Sq, Sk, hd, causal, packed)
CASES = {"causal packed G=2": (2, 4, 2, 96, 96, 64, True, True),
         "causal packed G=7 hd128": (1, 7, 1, 70, 70, 128, True, True),
         "cross 17x150": (2, 2, 2, 17, 150, 64, False, False)}


def bf16_parts(x, parts):
    """x ≈ Σ parts, each the bfloat16 rounding of what the earlier ones
    leave (`split_bf16_3` at three), smallest first."""
    out, rest = [], x
    for _ in range(parts):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out[::-1]


def _parts_product(a, b, parts):
    """Σ_c a[..., c] b[..., c, :] the way the kernel sums it: a (P or dS,
    float32) in bfloat16 parts, 16 columns a step, each part one product
    into the float32 sum, smallest first."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c0 in range(0, a.shape[-1], KSTEP):
        for p in bf16_parts(a[..., c0:c0 + KSTEP], parts):
            acc = acc + p @ b[..., c0:c0 + KSTEP, :]
    return acc


def _keep(B, Sq, Sk, causal, seg):
    """[B, Sq, Sk] bool: the entries the kernel keeps."""
    keep = torch.ones((B, Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= torch.ones((Sq, Sk), dtype=torch.bool).tril()
    if seg is not None:
        keep &= seg[:, :, None] == seg[:, None, :]
    return keep


def kernel_emulation(q, k, v, do, causal, seg=None, parts=3):
    """The tensor-core backward's arithmetic: q, do [B, H, Sq, hd]; k, v
    [B, KV, Sk, hd], all float32 holding bfloat16 values -> (dq, dk,
    dv) in float32 before the kernel's cast.  The forward's statistics
    (its float32 output and log-sum-exp) are the plain version's."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    keep = _keep(B, Sq, Sk, causal, seg)[:, None]       # [B, 1, Sq, Sk]
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.where(keep, (q @ kh.transpose(-1, -2)) * scale, -math.inf)
    lse = torch.logsumexp(s, dim=-1)                    # [B, H, Sq]
    o32 = torch.softmax(s, dim=-1) @ vh
    lse2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    D = (do * o32).sum(-1)

    def p_ds(qb, dob, kb, vb, lse2b, Db, keepb):
        """P and dS of a (query block, key block): [..., nq, nk]."""
        p = torch.exp2((qb @ kb.transpose(-1, -2)) * scale2 - lse2b[..., None])
        p = torch.where(keepb, p, 0.0)
        return p, p * ((dob @ vb.transpose(-1, -2)) - Db[..., None])

    nqb, nkb = -(-Sq // BLOCK), -(-Sk // BLOCK)
    dk = torch.zeros((B, KV, Sk, hd))
    dv = torch.zeros((B, KV, Sk, hd))
    qg = q.reshape(B, KV, G, Sq, hd)
    dog = do.reshape(B, KV, G, Sq, hd)
    lse2g, Dg = lse2.reshape(B, KV, G, Sq), D.reshape(B, KV, G, Sq)
    for kb in range(nkb):                  # dK/dV: a CTA a key block
        ks = slice(kb * BLOCK, (kb + 1) * BLOCK)
        for hh in range(G):
            for qb in range(kb if causal else 0, nqb):
                qs = slice(qb * BLOCK, (qb + 1) * BLOCK)
                p, ds = p_ds(qg[:, :, hh, qs], dog[:, :, hh, qs],
                             k[:, :, ks], v[:, :, ks], lse2g[:, :, hh, qs],
                             Dg[:, :, hh, qs], keep[:, :, qs, ks])
                pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
                dv[:, :, ks] += _parts_product(pt, dog[:, :, hh, qs], parts)
                dk[:, :, ks] += _parts_product(dst, qg[:, :, hh, qs], parts)
    dq = torch.zeros((B, H, Sq, hd))
    for qb in range(nqb):                  # dQ: a CTA a query block
        qs = slice(qb * BLOCK, (qb + 1) * BLOCK)
        for kb in range(qb + 1 if causal else nkb):
            ks = slice(kb * BLOCK, (kb + 1) * BLOCK)
            _, ds = p_ds(q[:, :, qs], do[:, :, qs], kh[:, :, ks],
                         vh[:, :, ks], lse2[:, :, qs], D[:, :, qs],
                         keep[:, :, qs, ks])
            dq[:, :, qs] += _parts_product(ds, kh[:, :, ks], parts)
    return dq * scale, dk * scale, dv


def _segments(B, S, seed):
    """Packed segment ids [B, S]: runs of 5-40 tokens."""
    rng = np.random.RandomState(seed)
    out = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.cumsum(rng.randint(5, 41, size=S))
        out[b] = np.searchsorted(cuts, np.arange(S), side="right") + 1
    return out


@functools.cache
def _case(name, seed=0):
    """bfloat16-exact numpy inputs of a case: q, k, v, do in the model's
    [B, L, heads, hd] layout, and the segment ids (or None)."""
    B, H, KV, Sq, Sk, hd, causal, packed = CASES[name]
    rng = np.random.RandomState(seed)

    def draw(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.bfloat16().float().numpy()
    q, k, v, do = (draw(B, Sq, H, hd), draw(B, Sk, KV, hd),
                   draw(B, Sk, KV, hd), draw(B, Sq, H, hd))
    return q, k, v, do, (_segments(B, Sq, seed + 1) if packed else None)


def _torch_case(name, dtype):
    q, k, v, do, seg = _case(name)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2).to(dtype)
                       for a in (q, k, v, do))
    return qt, kt, vt, dot, (None if seg is None else torch.from_numpy(seg))


def _plain_grads(fn, q, k, v, do, causal, seg):
    _, grads = chip_smoke.grads_of(
        torch, lambda a, b, c: fn(a, b, c, causal, seg), (q, k, v), do)
    return grads


def _witness_fn():
    with chip_smoke.reversed_orders(torch):
        return ref.flash_attention_ref


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_float32_matches_plain_gradient(name):
    """The transcription in float32 (before its cast) against the plain
    version's float32 gradient on the same bfloat16-exact inputs."""
    causal = CASES[name][6]
    q, k, v, do, seg = _torch_case(name, torch.float32)
    got = kernel_emulation(q, k, v, do, causal, seg)
    want = _plain_grads(ref.flash_attention_ref, q, k, v, do, causal, seg)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max())
        assert err <= K4_BWD_RTOL * float(w.abs().max()), (name, n, err)


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_bf16_within_the_witness(name):
    """The transcription cast to bfloat16 against the plain bfloat16
    gradient, within 1.5x the witness's bfloat16 ulps."""
    causal = CASES[name][6]
    q, k, v, do, seg = _torch_case(name, torch.bfloat16)
    got = kernel_emulation(*(t.float() for t in (q, k, v, do)), causal, seg)
    want = _plain_grads(ref.flash_attention_ref, q, k, v, do, causal, seg)
    wit = _plain_grads(_witness_fn(), q, k, v, do, causal, seg)
    for n, g, w, x in zip(("dq", "dk", "dv"), got, want, wit):
        chip_smoke.witness_check(torch, f"{name} {n}", g.bfloat16(), w, x)


def test_single_bf16_part_fails_the_witness_rule():
    """With P and dS in one bfloat16 part each (2^-9 instead of 2^-25)
    the causal packed case leaves the witness's 1.5x: the split into
    three parts is what keeps the tensor-core backward at the plain
    version's rounding."""
    name = "causal packed G=2"
    causal = CASES[name][6]
    q, k, v, do, seg = _torch_case(name, torch.bfloat16)
    f32 = [t.float() for t in (q, k, v, do)]
    want = _plain_grads(ref.flash_attention_ref, q, k, v, do, causal, seg)
    wit = _plain_grads(_witness_fn(), q, k, v, do, causal, seg)
    one = kernel_emulation(*f32, causal, seg, parts=1)
    ratios = [chip_smoke.bf16_ulps(torch, g.bfloat16(), w)
              / max(chip_smoke.bf16_ulps(torch, x, w), 1.0)
              for g, w, x in zip(one, want, wit)]
    assert max(ratios) > 1.5, ratios


def test_emulation_matches_jax_gradient():
    """The transcription (float32, before its cast) against jax.grad of
    the JAX package's naive attention on the causal packed G = 2 case's
    numpy inputs, the loss Σ out·dO."""
    name = "causal packed G=2"
    causal = CASES[name][6]
    q, k, v, do, seg = _case(name)

    def loss(q, k, v):
        return jnp.sum(jnaive(q, k, v, causal, seg) * do)
    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2))).lower(q, k, v).compile(
        {"xla_backend_optimization_level": 0})(q, k, v)
    got = kernel_emulation(*(torch.from_numpy(a).transpose(1, 2)
                             for a in (q, k, v, do)), causal,
                           torch.from_numpy(seg))
    for n, g, w in zip(("dq", "dk", "dv"), got, jg):
        g, w = g.transpose(1, 2).numpy(), np.asarray(w)
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), n
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=n)
