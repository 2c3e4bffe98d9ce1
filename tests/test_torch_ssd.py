"""The port's SSD scan (`repro_torch.models.layers.ssd`, the plain
version of K6 `kernels.ref.ssd_scan_ref` and its dispatcher
`kernels.ops.ssd_scan`) against the JAX package's, on the same numpy
inputs at Mamba2 head shapes cut to size (H 3, P 4, N 5).

Every JAX reference case is traced into one jitted program, compiled at
XLA's lowest backend optimisation level (the same function; it halves
the compile time on one core).
Tolerances, float32 against float32: y rtol = atol = 1e-4 and the state
1e-5 (measured: ≤ 2.1e-5 on |y| up to ~20 at L = 48, the two packages
summing the chunk products in other orders); the chunked form against
the sequential one, and the Pallas interpreter against the port, at
rtol = atol = 1e-4.

The Hopper kernel itself runs only on the card (`chip_smoke.py`); here
a torch transcription of its arithmetic (`kernel_emulation`: its chunk,
chunk-local states, hand-off and output, and the bf16 path's split of W,
z⊙x and the entering state) is held to the same references and to the
plain version at Mamba2-130M's head shapes, and the wrapper's launch
plan (`ssd_scan.ssd_plan`) is checked for coverage and shared
memory.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models.layers import ssd as jssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_scan_mod
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models.layers import ssd

torch.set_num_threads(1)

B, H, P, N = 2, 3, 4, 5
Y_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKED = [(16, False), (16, True), (48, False), (48, True)]  # (L, init)


def _inputs(L, seed):
    """x, dt (post-softplus), A (< 0), B, C and an initial state."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, L, H))).astype(np.float32)
    A = -np.exp(rng.randn(H)).astype(np.float32)
    Bm = rng.randn(B, L, N).astype(np.float32)
    Cm = rng.randn(B, L, N).astype(np.float32)
    s0 = rng.randn(B, H, N, P).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0})
def _references(cases):
    """Every JAX reference the tests compare with, in one program: the
    chunked SSD (chunk 16) of each CHUNKED case, the sequential SSD and
    one decode step."""
    out = {}
    for (L, init), (x, dt, A, Bm, Cm, s0) in zip(CHUNKED, cases["chunked"]):
        out[f"{L}-{init}"] = jssd.ssd_chunked(
            x, dt, A, Bm, Cm, chunk=16, init_state=s0 if init else None)
    out["sequential"] = jssd.ssd_sequential(*cases["sequential"][:5])
    out["ref"] = jref.ssd_scan_ref(*cases["sequential"][:5])
    s, x_t, dt_t, A, B_t, C_t = cases["decode"]
    out["decode"] = jssd.ssd_decode_step(s, x_t, dt_t, A, B_t, C_t)
    return out


@pytest.fixture(scope="module")
def cases():
    c = {"chunked": [_inputs(L, 10 + i) for i, (L, _) in
                     enumerate(CHUNKED)],
         "sequential": _inputs(32, 20)}
    x, dt, A, Bm, Cm, s0 = _inputs(1, 21)
    c["decode"] = (s0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    want = jax.tree.map(np.asarray, _references(c))
    return c, want


@pytest.mark.parametrize("L,init", CHUNKED)
def test_ssd_chunked_matches_reference(cases, L, init):
    c, want = cases
    x, dt, A, Bm, Cm, s0 = _t(c["chunked"][CHUNKED.index((L, init))])
    y, state = ssd.ssd_chunked(x, dt, A, Bm, Cm, chunk=16,
                               init_state=s0 if init else None)
    jy, js = want[f"{L}-{init}"]
    np.testing.assert_allclose(y.numpy(), jy, **Y_TOL)
    np.testing.assert_allclose(state.numpy(), js, **STATE_TOL)
    assert y.dtype == torch.float32 and state.dtype == torch.float32


def test_ssd_sequential_matches_reference(cases):
    c, want = cases
    args = _t(c["sequential"][:5])
    y, state = ssd.ssd_sequential(*args)
    np.testing.assert_allclose(y.numpy(), want["sequential"][0], **Y_TOL)
    np.testing.assert_allclose(state.numpy(), want["sequential"][1],
                               **STATE_TOL)
    # with an initial state: the first step scales it, as ssd_chunked's
    s0 = torch.from_numpy(c["sequential"][5])
    y0, st0 = ssd.ssd_sequential(*args, init_state=s0)
    yc, stc = ssd.ssd_chunked(*args, chunk=16, init_state=s0)
    np.testing.assert_allclose(y0.numpy(), yc.numpy(), **Y_TOL)
    np.testing.assert_allclose(st0.numpy(), stc.numpy(), **Y_TOL)


def test_ssd_decode_step_matches_reference(cases):
    c, want = cases
    y, state = ssd.ssd_decode_step(*_t(c["decode"]))
    np.testing.assert_allclose(y.numpy(), want["decode"][0], **Y_TOL)
    np.testing.assert_allclose(state.numpy(), want["decode"][1],
                               **STATE_TOL)


def test_ssd_scan_ref_is_the_chunked_form(cases):
    """The port's plain K6 (chunked, chunk min(256, L)) against the JAX
    package's `ssd_scan_ref` (the sequential form), y and final state;
    and through `ops.ssd_scan` on CPU tensors, which launches nothing."""
    c, want = cases
    args = _t(c["sequential"][:5])
    y, state = ref.ssd_scan_ref(*args)
    np.testing.assert_allclose(y.numpy(), want["ref"][0], **Y_TOL)
    np.testing.assert_allclose(state.numpy(), want["ref"][1], **Y_TOL)
    before = ssd_scan_cuda.launches
    y2, state2 = ops.ssd_scan(*args, chunk=16)
    yc, sc = ssd.ssd_chunked(*args, chunk=16)
    assert torch.equal(y2, yc) and torch.equal(state2, sc)
    assert ssd_scan_cuda.launches == before
    assert ops.launches()["ssd_scan"] == before


@pytest.fixture(scope="module")
def pallas_case():
    """Inputs (L = 16) and the Pallas kernel's y in interpret mode (two
    chunks of 8, one head a block), as tests/test_kernels.py runs it."""
    args = _inputs(16, 30)[:5]
    want = pallas_ssd_scan(*(jnp.asarray(a) for a in args), chunk=8,
                           block_h=1, interpret=True)
    return args, np.asarray(want)


def test_ssd_scan_ref_matches_pallas_interpret(pallas_case):
    """The port's plain K6 against the Pallas kernel in interpret mode."""
    args, want = pallas_case
    y, _ = ref.ssd_scan_ref(*_t(args), chunk=8)
    np.testing.assert_allclose(y.numpy(), want, **Y_TOL)


def test_chunk_contract_raises():
    """Where the JAX package's ssd_chunked asserts L % chunk == 0 the
    port raises the same error, on the plain route and the dispatcher's
    (which checks before it picks the route): L = 40 at chunk 16."""
    args = _t(_inputs(40, 40)[:5])
    with pytest.raises(AssertionError):
        ssd.ssd_chunked(*args, chunk=16)
    with pytest.raises(AssertionError):
        ops.ssd_scan(*args, chunk=16)
    with pytest.raises(AssertionError):
        ops.ssd_scan(*args, chunk=16, impl="cuda")
    y, _ = ops.ssd_scan(*args, chunk=40)          # one chunk of 40
    assert y.shape == args[0].shape


def test_ssd_scan_dispatch_needs_the_card():
    """A CPU tensor never reaches the kernel: impl="cuda" and the wrapper
    itself refuse it."""
    args = _t(_inputs(16, 50)[:5])
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(*args, chunk=16, impl="cuda")
    with pytest.raises(TypeError, match="CUDA"):
        ssd_scan_cuda(*args)


# ------------------------------------------------ K6's decomposition
def _bf16_split(v):
    """v = hi + lo with both bfloat16, as the kernel's bf16 path splits
    W, z⊙x and the entering state before its tensor-core products."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def kernel_emulation(x, dt, A, Bm, Cm, init_state=None,
                     chunk=ssd_scan_mod.CHUNK, split=False):
    """A torch transcription of csrc/ssd_scan.cu's arithmetic: chunks of
    `chunk` tokens (rows past L zero), the chunk-local states
    (`ssd_scan_states`), their hand-off in chunk order from the initial
    state (`ssd_scan_handoff`) and the output W x + exp(cum) C S_in
    (`ssd_scan_output`).  `split` rounds W, z⊙x
    and S_in to a bf16 high and low part before their products, as the
    bf16 path does (x, B and C are bf16 there, so exact)."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L

    def rows(t):                      # [B, L, ...] -> [B, nc, Q, ...]
        t = t.float()
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(B, nc, chunk, *t.shape[2:])
    xc, dtc, Bc, Cc = rows(x), rows(dt), rows(Bm), rows(Cm)
    cum = torch.cumsum(dtc * A.float(), dim=2)          # [B, nc, Q, H]
    total = cum[:, :, -1]
    z = torch.exp(total[:, :, None] - cum) * dtc
    if split:
        hi, lo = _bf16_split(z[..., None] * xc)
        s_loc = (torch.einsum("bcqn,bcqhp->bchnp", Bc, hi)
                 + torch.einsum("bcqn,bcqhp->bchnp", Bc, lo))
    else:
        s_loc = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc, z, xc)
    S = (torch.zeros((B, H, N, P)) if init_state is None
         else init_state.float())
    s_in = []
    for c in range(nc):
        s_in.append(S)
        S = S * torch.exp(total[:, c])[..., None, None] + s_loc[:, c]
    s_in = torch.stack(s_in, dim=1)                      # [B, nc, H, N, P]
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    diff = cum[:, :, :, None] - cum[:, :, None]          # [B, nc, i, j, H]
    W = torch.where(causal[None, None, ..., None],
                    cb[..., None] * torch.exp(diff) * dtc[:, :, None], 0.0)
    if split:
        (wh, wl), (sh, sl) = _bf16_split(W), _bf16_split(s_in)
        yi = (torch.einsum("bcijh,bcjhp->bcihp", wh, xc)
              + torch.einsum("bcijh,bcjhp->bcihp", wl, xc))
        yo = (torch.einsum("bcin,bchnp->bcihp", Cc, sh)
              + torch.einsum("bcin,bchnp->bcihp", Cc, sl))
    else:
        yi = torch.einsum("bcijh,bcjhp->bcihp", W, xc)
        yo = torch.einsum("bcin,bchnp->bcihp", Cc, s_in)
    y = yi + yo * torch.exp(cum)[..., None]
    return y.reshape(B, nc * chunk, H, P)[:, :L].to(x.dtype), S


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_kernel_emulation_matches_reference(cases, pallas_case, chunk,
                                            split):
    """The kernel's arithmetic against the JAX ssd_chunked (chunk 16) of
    every CHUNKED case and against the Pallas kernel in interpret mode:
    at chunk 16 the L = 48 cases take the hand-off across three chunks
    (with and without an initial state); at the kernel's own 64 one
    chunk.  The file's tolerances; the bf16 split (float32 inputs here)
    stays within them too."""
    c, want = cases
    for (L, init), arrays in zip(CHUNKED, c["chunked"]):
        x, dt, A, Bm, Cm, s0 = _t(arrays)
        y, state = kernel_emulation(x, dt, A, Bm, Cm, s0 if init else None,
                                    chunk=chunk, split=split)
        jy, js = want[f"{L}-{init}"]
        np.testing.assert_allclose(y.numpy(), jy, **Y_TOL)
        np.testing.assert_allclose(state.numpy(), js, **STATE_TOL)
    args, pallas_y = pallas_case
    y, _ = kernel_emulation(*_t(args), chunk=chunk, split=split)
    np.testing.assert_allclose(y.numpy(), pallas_y, **Y_TOL)


def _mamba_inputs(L, init, seed):
    """Mamba2-130M's head shapes (H 24, P 64, N 128), B = 1, made as
    chip_smoke.py makes them: x, B, C through SiLU, dt through softplus,
    A = -exp(U[0, log 16])."""
    rng = np.random.RandomState(seed)
    H, P, N = 24, 64, 128

    def silu(a):
        return a / (1.0 + np.exp(-a))
    x = silu(rng.randn(1, L, H, P))
    Bm, Cm = silu(rng.randn(1, L, N)), silu(rng.randn(1, L, N))
    dt = np.log1p(np.exp(rng.randn(1, L, H) - 1.0))
    A = -np.exp(rng.rand(H) * np.log(16.0))
    s0 = rng.randn(1, H, N, P) if init else None
    f32 = [np.asarray(a, np.float32) for a in (x, dt, A, Bm, Cm)]
    return [torch.from_numpy(a) for a in f32], (
        None if s0 is None else torch.from_numpy(s0.astype(np.float32)))


@pytest.mark.parametrize("L,init", [(25, False), (25, True), (512, False),
                                    (512, True)])
def test_kernel_emulation_at_mamba_shapes(L, init):
    """The kernel's arithmetic against its plain version at Mamba2-130M's
    head shapes, within chip_smoke.py's tolerances (|d| <= tol + tol·|want|):
    float32 y and state 1e-4; bf16 inputs through the bf16 split, y 1e-2
    (y is rounded to bf16 on both sides) and the float32 state 1e-4.
    Both against the plain version at the kernel's chunk of 64, and bf16
    also at the plain version's own chunk min(256, L), as chip_smoke.py
    compares.  (In float32 at L = 512 with an initial state the plain
    version at chunk 256 is itself up to 9.2e-5 of tol + |want| from a
    float64 recurrence on these inputs, where the kernel's chunk of 64 is
    2.1e-5 off: their difference, 1.02e-4, is the reference's rounding.)"""
    (x, dt, A, Bm, Cm), s0 = _mamba_inputs(L, init, 60 + L + init)
    for dtype, split, y_tol in ((torch.float32, False, 1e-4),
                                (torch.bfloat16, True, 1e-2)):
        xd, Bd, Cd = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
        y, state = kernel_emulation(xd, dt, A, Bd, Cd, s0, split=split)
        assert y.dtype == dtype and state.dtype == torch.float32
        chunks = [ssd_scan_mod.CHUNK] + ([256] if split else [])
        for chunk in chunks:
            wy, ws = ref.ssd_scan_ref(xd, dt, A, Bd, Cd, init_state=s0,
                                      chunk=chunk)
            for got, want, tol in ((y, wy, y_tol), (state, ws, 1e-4)):
                d = (got.float() - want.float()).abs()
                assert bool((d <= tol + tol * want.float().abs()).all()), \
                    (dtype, chunk, float(d.max()))


@pytest.mark.parametrize("B,L,H,P,N", [
    (1, 17, 24, 64, 128), (1, 25, 24, 64, 128), (1, 512, 24, 64, 128),
    (1, 1024, 24, 64, 128), (4, 256, 24, 64, 128), (12, 512, 24, 64, 128),
    (2, 70, 3, 40, 20), (1, 130, 5, 136, 256), (3, 64, 7, 8, 1),
    (2, 1100, 5, 64, 128)])
@pytest.mark.parametrize("bf16", [False, True])
def test_ssd_launch_plan(B, L, H, P, N, bf16):
    """The wrapper's plan, read as the source reads it: the CTAs of
    `ssd_scan_states` and `ssd_scan_output` (blockIdx (chunk, head group
    · P block, batch row), as `Cta` decodes it) cover every (batch row,
    head, chunk of 64, block of 64 columns) exactly once, and the threads
    of `ssd_scan_handoff` every (batch row, head, P block, padded state
    row, 4 columns); both kernels' shared memory fits an H100 CTA
    (227 KB)."""
    plan = ssd_scan_mod.ssd_plan(B, L, H, P, N, bf16)
    npb = -(-P // 64)
    assert plan.chunks == -(-L // 64) and plan.p_blocks == npb
    assert plan.n_pad % 16 == 0 and N <= plan.n_pad < N + 16
    assert 1 <= plan.heads <= ssd_scan_mod.MAX_HEADS
    assert plan.groups == -(-H // plan.heads)
    for kernel, smem in (("states", plan.smem_states),
                         ("output", plan.smem_output)):
        assert smem == ssd_scan_mod.smem_bytes(kernel, bf16, N, plan.heads)
        assert smem <= ssd_scan_mod.SMEM_LIMIT
    gx, gy, gz = plan.grid(B)
    seen = {}
    for c in range(gx):
        for y in range(gy):
            h0, pb = (y // npb) * plan.heads, y % npb
            heads = range(h0, min(H, h0 + plan.heads))
            assert len(heads) > 0 and 64 * c < L and 64 * pb < P
            for b in range(gz):
                for h in heads:
                    seen[(b, h, c, pb)] = seen.get((b, h, c, pb), 0) + 1
    assert seen == {(b, h, c, pb): 1 for b in range(B) for h in range(H)
                    for c in range(plan.chunks) for pb in range(npb)}
    # the hand-off: thread e -> (b, h, pb, n, q) as the source decodes it
    per_head = npb * plan.n_pad * 16
    e = np.arange(B * H * per_head)
    b, h, rem = e // (H * per_head), (e // per_head) % H, e % per_head
    pb, n, q = rem // (plan.n_pad * 16), (rem // 16) % plan.n_pad, rem % 16
    key = (((b * H + h) * npb + pb) * plan.n_pad + n) * 16 + q
    assert np.array_equal(np.sort(key), e) and int(b.max()) == B - 1
    assert plan.scratch_floats(B, H) == (B * plan.chunks * H * npb
                                         * plan.n_pad * 64)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("N", [128, 256])
def test_ssd_smem_fits_every_head_count(N, bf16):
    """At N = 128 and 256 every head count the plan may choose (1..4)
    fits the 227 KB of an H100 CTA, in both kernels."""
    for heads in range(1, ssd_scan_mod.MAX_HEADS + 1):
        for kernel in ("states", "output"):
            assert ssd_scan_mod.smem_bytes(kernel, bf16, N, heads) \
                <= ssd_scan_mod.SMEM_LIMIT
