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


def test_ssd_scan_ref_matches_pallas_interpret():
    """The port's plain K6 against the Pallas kernel in interpret mode
    (two chunks of 8, one head a block), as tests/test_kernels.py runs
    it."""
    args = _inputs(16, 30)[:5]
    want = pallas_ssd_scan(*(jnp.asarray(a) for a in args), chunk=8,
                           block_h=1, interpret=True)
    y, _ = ref.ssd_scan_ref(*_t(args), chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **Y_TOL)


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
