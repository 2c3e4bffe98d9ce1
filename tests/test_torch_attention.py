"""K4 `flash_attention` and K5 `decode_attention` (their plain versions,
which the CPU runs) and the port's attention layer against the JAX
package, on the same numpy inputs.

Tolerances: float32 rtol = atol = 1e-5 (the plain versions keep the
softmax probabilities in float32 where the JAX references cast them to
the input dtype first; at float32 that is rounding, measured below
2e-6), bfloat16 2e-2 (`tests/test_kernels.py`'s).  One case of each
kernel is also held against the Pallas kernel body in interpret mode,
and one length that is not a multiple of any tile against the
reference.

The JAX references' outputs on the parametrised kernel cases are stored
in `src/repro_torch/data/reference_attention.npz` (compiling the
reference for each case costs most of a second on one core); one case
of each kernel and dtype is recomputed live against the stored file.
Run as a script, this file rewrites it:

    PYTHONPATH=src python tests/test_torch_attention.py --write-references
"""
import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import attention as jattn
from repro.models.layers import rope as jrope
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import rope

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
STORED = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_attention.npz")
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

j_flash_ref = jax.jit(jref.flash_attention_ref, static_argnames=("causal",))
j_decode_ref = jax.jit(jref.decode_attention_ref)


def _pair(x, dtype):
    """One numpy float32 array as (torch, jax) tensors of `dtype` (both
    round to bfloat16 to nearest even; numpy converts for jax, so no
    conversion is compiled)."""
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), jnp.asarray(x.astype(jnp.bfloat16))
    return t, jnp.asarray(x)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tol(dtype):
    return BF16 if dtype == "bfloat16" else F32


def _close(got, want):
    """float32 layer outputs: rtol 1e-5, and atol 1e-5 of the largest
    magnitude (the d-sums of the projections cancel to near zero in
    places, where the summation order shows)."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# -------------------------------------------------------- K4 plain version
FLASH_CASES = [(1, 4, 2, 17, 16, True),     # a length no tile divides
               (2, 4, 4, 64, 32, False),
               (1, 8, 2, 100, 64, True),
               (1, 2, 1, 1, 16, True)]
DTYPES = ["float32", "bfloat16"]


def _flash_inputs(B, H, KV, S, hd, causal):
    rng = np.random.RandomState(S + hd)
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, S, hd)).astype(np.float32))


def _flash_reference(case, dtype):
    q, k, v = (_pair(a, dtype)[1] for a in _flash_inputs(*case))
    return _np(j_flash_ref(q, k, v, causal=case[-1]))


def _key(kind, case, dtype):
    return "_".join([kind, *map(str, case), dtype])


@functools.lru_cache(maxsize=None)
def _stored():
    with np.load(STORED) as z:
        return dict(z)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case, dtype):
    B, H, KV, S, hd, causal = case
    q, k, v = (_pair(a, dtype)[0] for a in _flash_inputs(*case))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (B, H, S, hd)
    np.testing.assert_allclose(_np(got), _stored()[_key("flash", case,
                                                        dtype)],
                               **_tol(dtype))


def test_flash_attention_matches_pallas_interpret():
    """The first case (S = 17: Pallas takes one 17-row block) through the
    Pallas kernel body: the port and the stored reference agree with
    it."""
    case = FLASH_CASES[0]
    q, k, v = _flash_inputs(*case)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=case[-1],
        impl="pallas_interpret"))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=case[-1])
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(_stored()[_key("flash", case, "float32")],
                               want, **F32)


# -------------------------------------------------------- K5 plain version
def _decode_inputs(B, KV, G, S, hd, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    lengths = rng.randint(1, S + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    return q, kc, vc, lengths


DECODE_CASES = [(2, 2, 4, 64, 16), (3, 4, 2, 100, 32), (2, 8, 2, 256, 128)]


def _decode_reference(case, dtype):
    B, KV, G, S, hd = case
    q, kc, vc, lengths = _decode_inputs(*case, S)
    out = j_decode_ref(_pair(q.reshape(B, KV * G, hd), dtype)[1],
                       _pair(kc, dtype)[1], _pair(vc, dtype)[1],
                       jnp.asarray(lengths))
    return _np(out).reshape(B, KV, G, hd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_matches_reference(case, dtype):
    B, KV, G, S, hd = case
    qn, kn, vn, lengths = _decode_inputs(*case, S)
    q, kc, vc = (_pair(a, dtype)[0] for a in (qn, kn, vn))
    got = ops.decode_attention(q, kc, vc, torch.from_numpy(lengths))
    assert got.dtype == q.dtype and got.shape == (B, KV, G, hd)
    np.testing.assert_allclose(_np(got), _stored()[_key("decode", case,
                                                        dtype)],
                               **_tol(dtype))


def test_stored_references_match_live():
    """The stored outputs are the JAX reference's own, to the compiler's
    last-ulp freedom: live on one bfloat16 case (one bfloat16 ulp); the
    interpret-mode tests check a float32 case of each kernel."""
    case = FLASH_CASES[0]
    np.testing.assert_allclose(_stored()[_key("flash", case, "bfloat16")],
                               _flash_reference(case, "bfloat16"),
                               rtol=8e-3, atol=1e-6)


def write_references(path=STORED):
    out = {}
    for dtype in DTYPES:
        for case in FLASH_CASES:
            out[_key("flash", case, dtype)] = _flash_reference(case, dtype)
        for case in DECODE_CASES:
            out[_key("decode", case, dtype)] = _decode_reference(case, dtype)
    np.savez_compressed(path, **out)
    print(f"wrote {len(out)} outputs to {path}")


def test_decode_attention_matches_pallas_interpret():
    """The first case through the Pallas kernel body (caches transposed
    to its [B, KV, S, hd] layout): the port and the stored reference
    agree with it."""
    case = DECODE_CASES[0]
    q, kc, vc, lengths = _decode_inputs(*case, case[3])
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.swapaxes(jnp.asarray(kc), 1, 2),
        jnp.swapaxes(jnp.asarray(vc), 1, 2), jnp.asarray(lengths),
        impl="pallas_interpret"))
    got = ops.decode_attention(*(torch.from_numpy(a)
                                 for a in (q, kc, vc, lengths)))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(_stored()[_key("decode", case, "float32")],
                               want, **F32)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the dispatcher takes the plain version; the
    kernels themselves (and impl="cuda") refuse it and count nothing."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    ops.reset_launches()
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(TypeError):
        flash_attention_cuda(x, x, x)
    with pytest.raises(TypeError):
        decode_attention_cuda(x, x, x, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.flash_attention(x, x, x, impl="cuda")
    assert ops.launches()["flash_attention"] == 0
    assert ops.launches()["decode_attention"] == 0


# ------------------------------------------------------------- the layer
@pytest.fixture(scope="module")
def layer():
    """Layer 0 of the reduced Qwen3-0.6B with numpy weights, in both
    packages' layouts."""
    from repro_torch.launch.serve import load_model
    from repro_torch.models import module
    cfg = configs.get_reduced("qwen3-0.6b")
    from repro import configs as jconfigs
    model = load_model(cfg, seed=4, device="cpu")
    tree = module.init(model.param_specs(), 4)
    jp = {k: jnp.asarray(v[0])
          for k, v in tree["blocks"]["slot_00"]["mixer"].items()}
    return cfg, jconfigs.get_reduced("qwen3-0.6b"), model.layers[0], jp


def test_rope_angles_match_reference():
    pos = np.arange(1024, dtype=np.int32)[None]
    angles = jax.jit(jrope.rope_angles, static_argnums=(0, 1))
    c, s = rope.rope_angles(128, 1e6, torch.from_numpy(pos))
    jc, js = angles(128, 1e6, jnp.asarray(pos))
    # the float32 frequencies differ by an ulp here and there, which
    # positions up to 1023 turn into angles apart by up to 7.6e-6
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    c, s = rope.rope_angles(16, 1e6, torch.from_numpy(pos[:, :64]))
    jc, js = angles(16, 1e6, jnp.asarray(pos[:, :64]))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)


def test_qkv_and_full_attention_match_reference(layer):
    cfg, jcfg, p, jp = layer

    @jax.jit
    def reference(jp, x, pos):
        cos, sin = jrope.rope_angles(jcfg.hd, jcfg.rope_theta, pos)
        q, k, v = jattn.qkv(jp, x, jcfg, cos, sin, jrope.apply_rope)
        o = jattn.full_attention(q, k, v, causal=True)
        return (q, k, v, o, jattn.out_proj(jp, o, jcfg),
                jattn.naive_attention(q, k, v))

    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(37), (2, 37)).copy()
    cos, sin = rope.rope_angles(cfg.hd, cfg.rope_theta, torch.from_numpy(pos))
    q, k, v = attn.qkv(p, torch.from_numpy(x), cfg, cos, sin)
    o = attn.full_attention(q, k, v, causal=True)
    got = (q, k, v, o, attn.out_proj(p, o), attn.naive_attention(q, k, v))
    for a, b in zip(got, reference(jp, jnp.asarray(x), jnp.asarray(pos))):
        _close(a, b)


def test_cache_update_and_decode_attention_match_reference(layer):
    cfg, _, _, _ = layer
    B, S, KV, hd, H = 3, 20, cfg.n_kv_heads, cfg.hd, cfg.n_heads
    rng = np.random.RandomState(3)
    kc, vc = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    pos = np.array([0, 7, S - 1], np.int32)

    @jax.jit
    def reference(kc, vc, kn, vn, q, pos):
        kc, vc = jattn.cache_update(kc, vc, kn, vn, pos)
        return kc, vc, jattn.decode_attention(q, kc, vc, pos + 1)

    jk, jv, jo = reference(*(jnp.asarray(a) for a in (kc, vc, kn, vn, q,
                                                      pos)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    attn.cache_update(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    o = attn.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(pos + 1))
    _close(o, jo)


# ------------------------------------------------------------- isolation
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (`repro`), at any indentation.  (That the port loads
    with jax blocked is test_torch_kernels_ref.py's
    test_port_imports_without_jax.)"""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [f for f in files if _FORBIDDEN.search(open(f).read())]
    assert not bad, bad


if __name__ == "__main__":
    if "--write-references" in sys.argv[1:]:
        write_references()
