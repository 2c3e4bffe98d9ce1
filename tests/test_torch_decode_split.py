"""K5's split of the sequence across CTAs, on the CPU.

`decode_attention.split_plan` (the wrapper's plan, read from shapes
only) must cover the cache capacity exactly once and give the card at
least one CTA per SM at the serving shapes.  A torch transcription of
what the kernel does with it (a partial softmax per split, empty splits
at weight 0, the partials merged in split order) must match both plain
versions, the port's `decode_attention_ref` and the JAX package's,
at rtol = atol = 1e-5 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (H100_SMS, MAX_SPLITS,
                                                  split_plan)

torch.set_num_threads(1)


def test_split_plan_covers_the_cache_and_fills_the_card():
    for B, KV, S in ((8, 8, 1024), (8, 16, 1024), (1, 8, 1024),
                     (1, 16, 1024), (8, 8, 100), (2, 2, 100000)):
        split, n = split_plan(B, KV, S)
        assert split & (split - 1) == 0 and 1 <= n <= MAX_SPLITS
        seen = np.zeros(S, np.int64)
        for s in range(n):
            seen[s * split:min((s + 1) * split, S)] += 1
        assert (seen == 1).all(), (B, KV, S)
        assert (n - 1) * split < S          # no split wholly past S
        if S == 1024 and (B, KV) in ((8, 8), (8, 16), (1, 8)):
            assert B * KV * n >= H100_SMS, (B, KV, split, n)


def split_merge(q, k_cache, v_cache, lengths, split):
    """The kernel's algorithm in float32: per batch row and split of
    `split` positions a partial (max, sum, accumulator); a split at or
    past lengths[b] is empty and weighs 0; the partials merge in split
    order."""
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    n = -(-S // split)
    out = torch.empty(q.shape, dtype=torch.float32)
    for b in range(B):
        L = int(lengths[b])
        parts = []
        for s in range(n):
            lo, hi = s * split, min((s + 1) * split, L)
            if lo >= hi:
                parts.append((torch.full((KV, G), ref.NEG_INF),
                              torch.zeros(KV, G), torch.zeros(KV, G, hd)))
                continue
            k = k_cache[b, lo:hi].float().transpose(0, 1)   # [KV, n, hd]
            v = v_cache[b, lo:hi].float().transpose(0, 1)
            sc = (q[b].float() @ k.transpose(-1, -2)) * hd ** -0.5
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), p @ v))
        live = [l > 0 for _, l, _ in parts]
        M = torch.stack([torch.where(lv, m, ref.NEG_INF)
                         for (m, _, _), lv in zip(parts, live)]).amax(0)
        tot = torch.zeros(KV, G)
        acc = torch.zeros(KV, G, hd)
        for (m, l, a), lv in zip(parts, live):
            w = torch.where(lv, torch.exp(m - M), 0.0)
            tot = tot + w * l
            acc = acc + w[..., None] * a
        out[b] = acc / torch.clamp_min(tot, 1e-30)[..., None]
    return out


def test_split_merge_matches_both_references():
    B, KV, G, hd, S = 4, 2, 2, 32, 256
    split, n = split_plan(B, KV, S)
    assert n > 2
    rng = np.random.RandomState(0)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    # one position, exactly one split, one split and one more, all of S
    lengths = np.array([1, split, split + 1, S], np.int32)
    got = split_merge(torch.from_numpy(q), torch.from_numpy(kc),
                      torch.from_numpy(vc), torch.from_numpy(lengths), split)
    want = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                                    torch.from_numpy(vc),
                                    torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jax_out = jax.jit(jref.decode_attention_ref)(
        jnp.asarray(q.reshape(B, KV * G, hd)), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_out).reshape(B, KV, G, hd),
                               rtol=1e-5, atol=1e-5)
