"""The port's plain kernel versions and dispatcher against the JAX
package's references (`repro.kernels.ref`, `repro.core.sgp.project_rows`)
and, once each, against the Pallas kernel bodies in interpret mode.

Inputs are made with numpy and handed to both packages.  Tolerances:
rtol 1e-6 for float32 fixed points (the same fold order on both sides;
only FMA contraction inside XLA may move the last ulp), 2e-2 for
bfloat16, atol 1e-6 for the QP rows against the oracle, 1e-4 against
the Pallas QP body (it bisects in division form, see its docstring).
Padded ≡ bucketed and stacked ≡ unstacked hold bitwise inside the port.
"""
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.sgp import project_rows
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import core as tcore
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

F32 = dict(rtol=1e-6, atol=1e-7)

# the references, jitted: eager while-loops re-trace on every call
_STATIC = ("reduce", "shift", "max_rounds", "return_rounds")
j_fold = jax.jit(jref.fold_reduce, static_argnames=("reduce",))
j_rounds = jax.jit(jref.edge_rounds_ref, static_argnames=_STATIC)
j_project_rows = jax.jit(project_rows)


def _dag(V, p=0.25, seed=0, isolate=()):
    """Random DAG adjacency (i -> j only for i < j) with ragged degrees;
    nodes in `isolate` lose their out-edges (all-masked rows)."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((V, V)) < p, 1)
    adj[:, 0] = False
    for i in isolate:
        adj[i, :] = False
    return adj


def _tiles(adj):
    """(port Neighbors on the CPU, reference Neighbors) of one adjacency."""
    return tcore.build_neighbors(adj, device="cpu"), jcore.build_neighbors(adj)


def _weights(nb, S, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((S, nb.V, nb.Dmax)) * nb.out_mask.numpy()[None]
    w = w / np.maximum(w.sum(-1, keepdims=True), 1.0)
    return w.astype(np.float32), rng.random((S, nb.V)).astype(np.float32)


def _dense_w(w, out_nbr, out_mask, V):
    Wd = np.zeros((w.shape[0], V, V))
    for i in range(V):
        for e in range(out_mask.shape[1]):
            if out_mask[i, e]:
                Wd[:, i, out_nbr[i, e]] += w[:, i, e]
    return Wd


# ------------------------------------------------------------ fold_reduce
@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("D", [1, 13, 45, 277])
def test_fold_reduce_matches_reference(D, reduce):
    msg = np.random.default_rng(D).random((3, 5, D)).astype(np.float32)
    got = ref.fold_reduce(torch.from_numpy(msg), reduce).numpy()
    want = np.asarray(j_fold(jnp.asarray(msg), reduce=reduce))
    np.testing.assert_allclose(got, want, **F32)


def test_fold_reduce_width_stable():
    """Zero-padding the slot axis to a wider power of two keeps every
    row's fold bit for bit (the padded ≡ bucketed contract)."""
    msg = torch.rand(4, 7, 5, generator=torch.Generator().manual_seed(0))
    wide = torch.nn.functional.pad(msg, (0, 123))
    for reduce in ("sum", "max"):
        assert torch.equal(ref.fold_reduce(msg, reduce),
                           ref.fold_reduce(wide, reduce))


# ---------------------------------------------------------- edge_rounds
SUM_CASES = [(V, S, dt) for V, S in [(24, 7), (65, 4)]
             for dt in (torch.float32, torch.bfloat16)]


@functools.cache
def _sum_references():
    """The reference's sum solves of every SUM_CASES case, traced into
    one program: one compile instead of one a case."""
    args = []
    for V, S, dtype in SUM_CASES:
        nb, jnb = _tiles(_dag(V))
        w, b = _weights(nb, S, 1)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        args.append((jnp.asarray(w, jdt), jnp.asarray(b, jdt), jnb.out_nbr,
                     jnb.out_mask))
    outs = jax.jit(lambda a: [jref.edge_rounds_ref(*x) for x in a])(args)
    return dict(zip(SUM_CASES, (np.asarray(o, np.float32) for o in outs)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,S", [(24, 7), (65, 4)])
def test_sum_parity_and_linear_solve(V, S, dtype):
    """reduce="sum" solves x = b + W x: port == reference == dense solve."""
    nb = tcore.build_neighbors(_dag(V), device="cpu")
    w, b = _weights(nb, S, 1)
    tw, tb = torch.from_numpy(w).to(dtype), torch.from_numpy(b).to(dtype)
    got = ops.edge_rounds(tw, tb, nb.out_nbr, nb.out_mask)
    assert got.dtype == dtype
    want = _sum_references()[(V, S, dtype)]
    tol = F32 if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    Wd = _dense_w(tw.double().numpy(), nb.out_nbr.numpy(),
                  nb.out_mask.numpy(), V)
    exact = np.linalg.solve(np.eye(V)[None] - Wd,
                            tb.double().numpy()[..., None])[..., 0]
    np.testing.assert_allclose(got.float().numpy(), exact,
                               **(dict(rtol=1e-5, atol=1e-6)
                                  if dtype == torch.float32 else tol))


def test_max_boolean_closure():
    """reduce="max" on a {0, 1} encoding is the boolean-or closure."""
    V, S = 31, 5
    nb, jnb = _tiles(_dag(V, seed=2))
    rng = np.random.default_rng(5)
    sup = (rng.random((S, V, nb.Dmax)) < 0.6) & nb.out_mask.numpy()[None]
    seed_nodes = rng.random((S, V)) < 0.15
    for dtype in (torch.float32, torch.bfloat16):
        got = ops.edge_rounds(torch.from_numpy(sup).to(dtype),
                              torch.from_numpy(seed_nodes).to(dtype),
                              nb.out_nbr, nb.out_mask, reduce="max") > 0.5
        want = np.asarray(j_rounds(
            jnp.asarray(sup, jnp.float32),
            jnp.asarray(seed_nodes, jnp.float32), jnb.out_nbr, jnb.out_mask, reduce="max")) > 0.5
        np.testing.assert_array_equal(got.numpy(), want)
    Sd = _dense_w(sup.astype(np.float64), nb.out_nbr.numpy(),
                  nb.out_mask.numpy(), V) > 0
    closure = seed_nodes.copy()
    for _ in range(V):
        closure = closure | np.einsum("sij,sj->si", Sd, closure)
    np.testing.assert_array_equal(got.numpy(), closure)


def test_max_shift_longest_path():
    """reduce="max", shift=1 is the longest-support-path recursion."""
    V, S = 29, 3
    adj = _dag(V, seed=7)
    nb, jnb = _tiles(adj)
    w = nb.out_mask.float()[None].expand(S, V, nb.Dmax)
    got = ops.edge_rounds(w, torch.zeros(S, V), nb.out_nbr, nb.out_mask,
                          reduce="max", shift=1.0)
    want = j_rounds(jnp.asarray(w.numpy()), jnp.zeros((S, V)),
                    jnb.out_nbr, jnb.out_mask, reduce="max", shift=1.0)
    h = np.zeros(V)
    for i in range(V - 1, -1, -1):
        js = np.nonzero(adj[i])[0]
        h[i] = 1 + h[js].max() if len(js) else 0.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(h, (S, V)))


def test_padded_slots_and_isolated_nodes():
    """NaN in padded weight slots never leaks; isolated rows return the
    inject exactly."""
    V, S, isolate = 22, 6, (3, 11, 21)
    nb, _ = _tiles(_dag(V, seed=4, isolate=isolate))
    w, b = _weights(nb, S, 4)
    w_nan = torch.where(nb.out_mask, torch.from_numpy(w), float("nan"))
    got = ops.edge_rounds(w_nan, torch.from_numpy(b), nb.out_nbr,
                          nb.out_mask)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[:, list(isolate)].numpy(),
                                  b[:, list(isolate)])


def test_early_exit_round_count():
    """A depth-4 chain in a V=48 graph converges in ~5 rounds, not V,
    and the port counts the same rounds as the reference."""
    V, S = 48, 3
    adj = np.zeros((V, V), bool)
    for i in range(1, 5):
        adj[i, i + 1] = True
    nb, jnb = _tiles(adj)
    w = torch.full((S, V, nb.Dmax), 0.5)
    x, k = ops.edge_rounds(w, torch.ones(S, V), nb.out_nbr, nb.out_mask,
                           max_rounds=V, return_rounds=True)
    _, jk = j_rounds(jnp.asarray(w.numpy()), jnp.ones((S, V)),
                     jnb.out_nbr, jnb.out_mask, max_rounds=V,
                     return_rounds=True)
    assert k == int(jk) and k <= 6
    np.testing.assert_allclose(float(x[0, 1]),
                               sum(0.5 ** j for j in range(5)), rtol=1e-6)


def _ba_adj(V=120, seed=3):
    return tcore.topologies.barabasi_albert(V=V, m=2, seed=seed)


BUCKET_CASES = [("sum", 0.0), ("max", 0.0), ("max", 1.0)]


def _bucket_inputs(reduce):
    nb = tcore.build_neighbors(_ba_adj(), device="cpu")
    w, b = _weights(nb, 4, 9)
    if reduce == "max":
        w, b = (w > 0.2).astype(np.float32), (b > 0.9).astype(np.float32)
    return w, b


@functools.cache
def _bucketed_references():
    """The reference's bucketed solves of every BUCKET_CASES case, traced
    into one program: one compile instead of one a case."""
    jbk = jcore.build_buckets(_ba_adj())

    def solve_all(args, eb):
        return [jref.edge_rounds_bucketed_ref(w, b, eb, reduce=r, shift=s)
                for (w, b), (r, s) in zip(args, BUCKET_CASES)]

    args = [tuple(map(jnp.asarray, _bucket_inputs(r))) for r, _ in
            BUCKET_CASES]
    outs = jax.jit(solve_all)(args, jbk.out)
    return dict(zip(BUCKET_CASES, map(np.asarray, outs)))


@pytest.mark.parametrize("reduce,shift", BUCKET_CASES)
def test_bucketed_bitwise_padded(reduce, shift):
    """Degree buckets reproduce the padded tiles bit for bit (values and
    round counts) and match the reference's bucketed solve."""
    adj = _ba_adj()
    nb = tcore.build_neighbors(adj, device="cpu")
    bk = tcore.build_buckets(adj, device="cpu")
    w, b = _bucket_inputs(reduce)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    for eb, (nbr, mask, w_in) in (
            (bk.out, (nb.out_nbr, nb.out_mask, tw)),
            (bk.inn, (nb.in_nbr, nb.in_mask,
                      tw[:, nb.in_nbr, nb.in_slot]))):
        pad, kp = ops.edge_rounds(w_in, tb, nbr, mask, reduce=reduce,
                                  shift=shift, max_rounds=nb.V,
                                  return_rounds=True)
        bkt, kb = ops.edge_rounds_bucketed(tw, tb, eb, reduce=reduce,
                                           shift=shift, max_rounds=nb.V,
                                           return_rounds=True)
        assert torch.equal(pad, bkt) and kp == kb
    np.testing.assert_allclose(
        ops.edge_rounds_bucketed(tw, tb, bk.out, reduce=reduce,
                                 shift=shift).numpy(),
        _bucketed_references()[(reduce, shift)], **F32)


def test_stacked_equals_unstacked():
    nb, _ = _tiles(_dag(40, seed=11))
    w1, b1 = _weights(nb, 3, 1)
    w2, b2 = _weights(nb, 5, 2)
    probs = [(torch.from_numpy(w1), torch.from_numpy(b1)),
             (torch.from_numpy(w2), torch.from_numpy(b2))]
    outs = ops.edge_rounds_stacked(probs, nb.out_nbr, nb.out_mask)
    for (w, b), got in zip(probs, outs):
        assert torch.equal(got, ops.edge_rounds(w, b, nb.out_nbr,
                                                nb.out_mask))


def test_pallas_interpret_edge_rounds_and_bucketed():
    """The Pallas K1 and K2 bodies (interpret mode) agree with the port."""
    adj = _ba_adj(V=64, seed=5)
    nb = tcore.build_neighbors(adj, device="cpu")
    bk = tcore.build_buckets(adj, device="cpu")
    jnb, jbk = jcore.build_neighbors(adj), jcore.build_buckets(adj)
    w, b = _weights(nb, 3, 7)
    got = ops.edge_rounds(torch.from_numpy(w), torch.from_numpy(b),
                          nb.out_nbr, nb.out_mask)
    k1 = jops.edge_rounds(jnp.asarray(w), jnp.asarray(b), jnb.out_nbr,
                          jnb.out_mask, impl="pallas_interpret")
    k2 = jops.edge_rounds_bucketed(jnp.asarray(w), jnp.asarray(b), jbk.out,
                                   impl="pallas_interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(k1), **F32)
    np.testing.assert_allclose(
        ops.edge_rounds_bucketed(torch.from_numpy(w), torch.from_numpy(b),
                                 bk.out).numpy(), np.asarray(k2), **F32)


def test_dispatch_shape_checks_and_impl():
    nb, _ = _tiles(_dag(10, seed=1))
    w = torch.zeros(2, 10, nb.Dmax + 1)
    with pytest.raises(ValueError, match="not aligned"):
        ops.edge_rounds(w, torch.zeros(2, 10), nb.out_nbr, nb.out_mask)
    bk = tcore.build_buckets(_dag(10, seed=1), device="cpu")
    with pytest.raises(ValueError, match="not aligned"):
        ops.edge_rounds_bucketed(torch.zeros(2, 9, nb.Dmax),
                                 torch.zeros(2, 9), bk.out)
    w = torch.zeros(2, 10, nb.Dmax)
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.edge_rounds(w, torch.zeros(2, 10), nb.out_nbr, nb.out_mask,
                        impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.simplex_project(w, w, w, w > 0, impl="pallas")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: no quiet plain-version path."""
    from repro_torch.kernels.edge_rounds import (edge_rounds_bucketed_cuda,
                                                 edge_rounds_cuda)
    from repro_torch.kernels.simplex_project import simplex_project_cuda
    adj = _dag(12, seed=1)
    nb = tcore.build_neighbors(adj, device="cpu")
    bk = tcore.build_buckets(adj, device="cpu")
    w, b = torch.zeros(2, 12, nb.Dmax), torch.zeros(2, 12)
    with pytest.raises(ValueError, match="CUDA"):
        edge_rounds_cuda(w, b, nb.out_nbr.int(), nb.out_mask.byte())
    with pytest.raises(ValueError, match="CUDA"):
        edge_rounds_bucketed_cuda(w, b, bk.out)
    with pytest.raises(TypeError, match="CUDA"):
        simplex_project_cuda(w[0], w[0], w[0], w[0] > 0)
    assert edge_rounds_cuda.launches == 0 == simplex_project_cuda.launches


# ------------------------------------------------------- simplex_project
def _qp_rows(R, K, seed):
    rng = np.random.default_rng(seed)
    phi = rng.random((R, K)).astype(np.float32)
    phi /= phi.sum(-1, keepdims=True)
    delta = (rng.random((R, K)) * 3).astype(np.float32)
    delta[::7, :3] = 0.5                      # argmin ties: first wins
    # well-conditioned scalings (w = 1/2M <= 2 keeps one ulp of λ under
    # the 1e-6 tolerance whatever the summation order), plus rows of
    # vanishing scaling that snap to a one-hot
    M = (rng.random((R, K)) * 2 + 0.25).astype(np.float32)
    M[::5] = 1e-14
    perm = rng.random((R, K)) < 0.7
    perm[::11] = False                        # fully blocked rows
    perm[1::13] = False
    perm[1::13, min(2, K - 1)] = True         # a single permitted coordinate
    return phi, delta, M, perm


@pytest.mark.parametrize("R,K", [(200, 15), (64, 278), (33, 1)])
def test_simplex_project_matches_oracle(R, K):
    phi, delta, M, perm = _qp_rows(R, K, K)
    got = ops.simplex_project(*(torch.from_numpy(a) for a in
                                (phi, delta, M, perm)))
    want = j_project_rows(jnp.asarray(phi), jnp.asarray(delta), jnp.asarray(M),
                        jnp.asarray(perm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    sums = got.sum(-1).numpy()
    live = perm.any(-1)
    np.testing.assert_allclose(sums[live], 1.0, atol=1e-5)
    assert (got.numpy()[~live] == 0).all()
    assert (got.numpy()[~perm] == 0).all()


def _fused_left_to_right_qp(phi, delta, M, perm, n_iter=60):
    """The QP rows with XLA's CPU arithmetic for K <= 32: q - λw as one
    fused multiply-add (emulated through float64, where the product of
    two float32 is exact) and every row sum taken left to right."""
    q, w, d, lo, hi = ref.dual_setup(*(torch.from_numpy(a) for a in
                                       (phi, delta, M, perm)))

    def v_of(lam):
        return torch.clamp_min((q.double() - lam.double() * w.double())
                               .float(), 0.0)

    def row_sum(x):
        acc = torch.zeros_like(x[:, :1])
        for j in range(x.shape[1]):
            acc = acc + x[:, j:j + 1]
        return acc

    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        up = row_sum(v_of(mid)) > 1.0
        lo2, hi2 = torch.where(up, mid, lo), torch.where(up, hi, mid)
        if torch.equal(lo2, lo) and torch.equal(hi2, hi):
            break
        lo, hi = lo2, hi2
    v = v_of(0.5 * (lo + hi))
    v = torch.where(v > 1e-12, v, 0.0)
    s = row_sum(v)
    live = torch.from_numpy(perm).any(-1, keepdim=True)
    return torch.where(live & (s > 0), v / torch.clamp_min(s, 1e-30), 0.0)


@pytest.mark.parametrize("K", [10, 15])
def test_reference_qp_arithmetic_is_fused_left_to_right(K):
    """The JAX package's QP on the CPU sums each row of K <= 32 left to
    right and fuses q - λw into one rounding: that arithmetic reproduces
    it bit for bit, on rows scaled like the lightly loaded sw_linear rows
    (w = 1/2M up to 10, where one ulp of λ shows).  The port keeps
    torch's order (ROADMAP §3 says why)."""
    phi, delta, M, perm = _qp_rows(3000, K, 40 + K)
    M = (M * 0 + np.random.default_rng(K).random(M.shape) * 0.5
         + 0.05).astype(np.float32)
    perm[:, 0] = True                         # no blocked rows here
    want = np.asarray(j_project_rows(*(jnp.asarray(a) for a in
                                       (phi, delta, M, perm))))
    np.testing.assert_array_equal(
        _fused_left_to_right_qp(phi, delta, M, perm).numpy(), want)
    got = ops.simplex_project(*(torch.from_numpy(a) for a in
                                (phi, delta, M, perm)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pallas_interpret_simplex_project():
    phi, delta, M, perm = _qp_rows(48, 15, 3)
    got = ops.simplex_project(*(torch.from_numpy(a) for a in
                                (phi, delta, M, perm)))
    k3 = jops.simplex_project(jnp.asarray(phi), jnp.asarray(delta),
                              jnp.asarray(M), jnp.asarray(perm),
                              impl="pallas_interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(k3), atol=1e-4)


# ------------------------------------------------------------ isolation
def test_port_imports_without_jax():
    """The port loads with jax made unimportable and pulls in nothing of
    the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.launch.serve, repro_torch.serving\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.models.layers.mamba\n"
        "import repro_torch.models.layers.ssd\n"
        "import repro_torch.models.layers.moe, repro_torch.core.moe_bridge\n"
        "import repro_torch.kernels.moe_gmm\n"
        "bad = [m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.') or m.startswith('jax')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print('ok')\n")
    import os
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
