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
import dataclasses
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
from repro_torch.kernels import edge_rounds as er_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import simplex_project as sp_mod

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


# --------------------------------------------- K2's cluster plan (card)
def _cluster_rounds(w, b, eb, plan, reduce, shift, max_rounds):
    """A transcription of K2's partitioned round (`csrc/edge_rounds.cu`,
    edge_rounds_bucketed_kernel): rank r holds the state of its rows
    [row_start[r], row_start[r+1]) in row order; each round every rank
    folds its bucket rows from the previous round's state of whichever
    rank owns each neighbour (the plan's packed `loc`) and writes its
    own rows' next state; the barrier is the next round reading only
    what this one wrote.  Returns (x [S, V], rounds)."""
    combine = ref._combine(reduce)
    c = plan.size
    rs, rows = plan.row_start.tolist(), eb.row_off.tolist()
    lanes = eb.lane_off.tolist()
    owner, local = (plan.loc & 15).long(), (plan.loc >> 4).long()
    wf, bf = w.float(), b.float()
    S, cap = w.shape[0], max(plan.rows_cap, 1)
    x0 = torch.zeros((S, c, cap))
    for r in range(c):
        x0[:, r, :rs[r + 1] - rs[r]] = bf[:, eb.nodes[rs[r]:rs[r + 1]].long()]
    segs = []                      # (rank, local rows, lanes, width)
    for r in range(c):
        for k, Db in enumerate(eb.widths):
            ra, rb = max(rows[k], rs[r]), min(rows[k + 1], rs[r + 1])
            if ra < rb:
                q0 = lanes[k] + (ra - rows[k]) * Db
                segs.append((r, slice(ra - rs[r], rb - rs[r]),
                             slice(q0, q0 + (rb - ra) * Db), Db,
                             eb.nodes[ra:rb].long()))

    def step(x):
        y = torch.zeros_like(x)
        for r, lr, q, Db, nodes in segs:
            def tile(t):
                return t[q].long().reshape(-1, Db)
            wt = torch.where(tile(eb.mask) > 0,
                             wf[:, tile(eb.wsrc), tile(eb.wslot)], 0.0)
            xj = x[:, tile(owner), tile(local)]
            red = ref.fold_reduce(wt * (xj + shift), reduce)
            y[:, r, lr] = combine(bf[:, nodes], red)
        return y

    x, k = ref.fixed_point(step, x0, max_rounds)
    out = torch.empty_like(bf)
    for r in range(c):
        out[:, eb.nodes[rs[r]:rs[r + 1]].long()] = x[:, r, :rs[r + 1] - rs[r]]
    return out, k


def _sw_adj(V=150, seed=4):
    return tcore.topologies.small_world(V=V, n_short=V, n_long=V,
                                        seed=seed)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_cluster_plan_covers_every_lane_and_node_once(c):
    """K2's rank plan splits both bucket sets of a BA and an SW graph
    into contiguous row ranges whose lanes follow them, balanced by lanes
    to within the widest row, and packs every lane's neighbour as its
    owner rank and the row it holds there."""
    for adj in (_ba_adj(), _sw_adj()):
        bk = tcore.build_buckets(adj, device="cpu")
        for eb in (bk.out, bk.inn):
            plan = er_mod.cluster_plan(eb, c)
            assert plan.size == c
            rs, ls = plan.row_start.long(), plan.lane_start
            assert rs[0] == 0 and rs[-1] == eb.nodes.numel()
            assert ls[0] == 0 and ls[-1] == eb.lanes
            assert bool((rs[1:] >= rs[:-1]).all())
            row_lane = torch.cat([
                eb.lane_off[k] + torch.arange(eb.row_off[k + 1]
                                              - eb.row_off[k]) * Db
                for k, Db in enumerate(eb.widths)]
                + [torch.tensor([eb.lanes])])
            assert torch.equal(ls, row_lane[rs])
            assert int((ls[1:] - ls[:-1]).max()) <= plan.lanes_cap
            assert int((rs[1:] - rs[:-1]).max()) <= plan.rows_cap
            assert plan.rows_cap % 4 == 0 == plan.lanes_cap % 4
            assert int((ls[1:] - ls[:-1]).max()) \
                <= -(-eb.lanes // c) + max(eb.widths)
            # every node is one rank's row, every lane one rank's lane
            owner_of_row = torch.bucketize(torch.arange(eb.nodes.numel()),
                                           rs[1:], right=True)
            owner = torch.empty(eb.nodes.numel(), dtype=torch.long)
            local = torch.empty_like(owner)
            owner[eb.nodes.long()] = owner_of_row
            local[eb.nodes.long()] = torch.arange(eb.nodes.numel()) \
                - rs[owner_of_row]
            assert torch.equal(torch.sort(eb.nodes.long()).values,
                               torch.arange(eb.nodes.numel()))
            nbr = eb.nbr.long()
            assert torch.equal((plan.loc & 15).long(), owner[nbr])
            assert torch.equal((plan.loc >> 4).long(), local[nbr])
            assert er_mod.cluster_plan(eb, c) is plan


@pytest.mark.parametrize("reduce,shift", BUCKET_CASES)
def test_cluster_transcription_bitwise(reduce, shift):
    """The transcription of K2's partitioned round on the rank plans of
    c in {2, 8} equals the plain bucketed version bit for bit (values
    and rounds) on BA and SW graphs, in both edge directions, and the
    JAX package's bucketed reference at float32 tolerance."""
    for adj in (_ba_adj(), _sw_adj()):
        nb = tcore.build_neighbors(adj, device="cpu")
        bk = tcore.build_buckets(adj, device="cpu")
        w, b = _weights(nb, 3, 21)
        if reduce == "max":
            w, b = (w > 0.2).astype(np.float32), (b > 0.9).astype(np.float32)
        tw, tb = torch.from_numpy(w), torch.from_numpy(b)
        for eb, c in ((bk.out, 8), (bk.inn, 2)):
            want, kw = ref.edge_rounds_bucketed_ref(tw, tb, eb, reduce,
                                                    shift, nb.V)
            got, k = _cluster_rounds(tw, tb, eb, er_mod.cluster_plan(eb, c),
                                     reduce, shift, nb.V)
            assert torch.equal(got, want) and k == kw
    w, b = _bucket_inputs(reduce)
    bk = tcore.build_buckets(_ba_adj(), device="cpu")
    got, _ = _cluster_rounds(torch.from_numpy(w), torch.from_numpy(b),
                             bk.out, er_mod.cluster_plan(bk.out, 4), reduce,
                             shift, w.shape[1])
    np.testing.assert_allclose(got.numpy(),
                               _bucketed_references()[(reduce, shift)], **F32)


def test_cluster_size_from_shapes(monkeypatch):
    """c from S and the lanes alone: 8 CTAs a row at ba_10000's S = 16
    (128 CTAs), 4 for its stacked taint pair, fewer on small graphs;
    a plan that cannot fit doubles c, then is refused."""
    assert er_mod.cluster_size(16, 50030) == 8
    assert er_mod.cluster_size(32, 50030) == 4
    assert er_mod.cluster_size(64, 50030) == 2
    assert er_mod.cluster_size(200, 50030) == 1
    assert er_mod.cluster_size(1, 3000) == 2
    assert er_mod.max_nodes() == 16 * 232448 // 12
    eb = tcore.build_buckets(_ba_adj(), device="cpu").out
    monkeypatch.setattr(er_mod, "_SMEM_BYTES", er_mod.k2_smem_bytes(
        -(-eb.nodes.numel() // 8) + 4, -(-eb.lanes // 4) + 4))
    plan = er_mod.cluster_plan(dataclasses.replace(eb, plans={}), 1)
    assert plan.size > 1 and plan.smem_bytes <= er_mod._SMEM_BYTES
    monkeypatch.setattr(er_mod, "_SMEM_BYTES", er_mod.k2_smem_bytes(0, 0))
    with pytest.raises(ValueError, match="no second path"):
        er_mod.cluster_plan(dataclasses.replace(eb, plans={}), 1)


# --------------------------------------------- K1's cluster plan (card)
def _k1_ranks(V, c):
    """K1's arithmetic plan (`csrc/edge_rounds.cu` k1_row, k1_pack): rank
    r owns nodes [start[r], start[r+1]), start[r] = ⌈rV/c⌉, and node j
    lives on rank ⌊jc/V⌋ at row j - start[rank]."""
    start = torch.tensor([-(-r * V // c) for r in range(c + 1)])

    def pack(j):
        owner = j * c // V
        return owner, j - start[owner]
    return start, pack


def _k1_rounds(w, b, nbr, mask, c, reduce, shift, max_rounds):
    """A transcription of K1's partitioned round (edge_rounds_kernel):
    rank r holds its nodes' state in row order; each round it folds its
    nodes' [D] lane rows from the previous round's state of the rank
    that owns each neighbour and writes its own rows' next state.
    Returns (x [S, V], rounds)."""
    combine = ref._combine(reduce)
    V = nbr.shape[0]
    start, pack = _k1_ranks(V, c)
    owner, local = pack(nbr.long())
    size = (start[1:] - start[:-1]).tolist()
    wf = torch.where(mask.bool(), w.float(), 0.0)
    bf = b.float()
    x0 = torch.zeros((w.shape[0], c, max(max(size), 1)))
    for r in range(c):
        x0[:, r, :size[r]] = bf[:, start[r]:start[r + 1]]

    def step(x):
        y = torch.zeros_like(x)
        for r in range(c):
            rows = slice(int(start[r]), int(start[r + 1]))
            xj = x[:, owner[rows], local[rows]]
            red = ref.fold_reduce(wf[:, rows] * (xj + shift), reduce)
            y[:, r, :size[r]] = combine(bf[:, rows], red)
        return y

    x, k = ref.fixed_point(step, x0, max_rounds)
    return torch.cat([x[:, r, :size[r]] for r in range(c)], dim=1), k


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_k1_plan_covers_every_lane_and_node_once(c):
    """K1's ranks split the nodes of a padded tile into contiguous ranges
    of at most `k1_plan`'s rows_cap rows (their lanes follow them), and
    every neighbour's packed (rank, row) names the node it gathers."""
    for V in (150, 1000, 1001, 13):
        start, pack = _k1_ranks(V, c)
        size = start[1:] - start[:-1]
        assert start[0] == 0 and start[-1] == V and bool((size >= 0).all())
        assert int(size.max()) - int(size.min()) <= 1
        rows_cap = -(-(-(-V // c)) // 4) * 4
        assert int(size.max()) <= rows_cap
        j = torch.arange(V)
        owner, local = pack(j)
        assert bool(((0 <= local) & (local < size[owner])).all())
        assert torch.equal(start[owner] + local, j)
        assert bool((owner < 16).all()) and int(local.max()) < 1 << 27
        lanes = torch.cat([torch.arange(int(start[r]) * 14,
                                        int(start[r + 1]) * 14)
                           for r in range(c)])
        assert torch.equal(lanes, torch.arange(V * 14))


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_k1_lane_map_folds_in_fold_reduce_order(reduce):
    """K1's lane map (edge_rounds.cu fold_nodes): a node's padded width P
    on g = P / C lanes, lane l holding slots l, l+g, ..., l+(C-1)g; the
    lane-local halvings, then shuffles down by g/2 .. 1 inside the group,
    give fold_reduce bit for bit, for every C the wrappers can pick (K2
    folds narrow tiles one slot a lane, K1 K1_SLOTS or K1_SLOTS_SHARED)."""
    rng = np.random.default_rng(7)
    for D in (1, 2, 3, 7, 14, 16, 29, 45, 277):
        P = 1 if D <= 1 else 1 << (D - 1).bit_length()
        msg = torch.from_numpy(rng.random((64, D)).astype(np.float32))
        want = ref.fold_reduce(msg, reduce)
        op = torch.add if reduce == "sum" else torch.maximum
        padded = torch.nn.functional.pad(msg, (0, P - D)).abs()
        for slots in (1, er_mod.K1_SLOTS_SHARED, er_mod.K1_SLOTS):
            C = er_mod._slots_per_lane(D, slots)
            g = P // C
            a = padded.reshape(64, C, g)          # a[:, c, l]: slot l + g·c
            h = C // 2
            while h:
                a = op(a[:, :h], a[:, h:2 * h])
                h //= 2
            v = a[:, 0]                           # [64, g], lane l's residue
            off = g // 2
            while off:                            # __shfl_down_sync, width g
                lanes = torch.arange(g)
                src = torch.where(lanes + off < g, lanes + off, lanes)
                v = op(v, v[:, src])
                off //= 2
            assert torch.equal(v[:, 0], want), (D, slots)


@pytest.mark.parametrize("reduce,shift", BUCKET_CASES)
def test_k1_transcription_bitwise(reduce, shift):
    """The transcription of K1's partitioned round on c in {2, 8} equals
    the plain padded version bit for bit (values and rounds) on a small
    world graph like sw_1000, on its in-edge and out-edge tiles."""
    nb = tcore.build_neighbors(_sw_adj(), device="cpu")
    w, b = _weights(nb, 3, 23)
    if reduce == "max":
        w, b = (w > 0.2).astype(np.float32), (b > 0.9).astype(np.float32)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    for nbr, mask, wt in ((nb.out_nbr, nb.out_mask, tw),
                          (nb.in_nbr, nb.in_mask,
                           tw[:, nb.in_nbr, nb.in_slot])):
        want, kw = ref.edge_rounds_ref(wt, tb, nbr, mask, reduce, shift,
                                       nb.V)
        for c in (2, 8):
            got, k = _k1_rounds(wt, tb, nbr, mask, c, reduce, shift, nb.V)
            assert torch.equal(got, want) and k == kw


def test_k1_plan_from_shapes():
    """K1's cluster from the shapes: sw_1000's S = 64 rows and its
    stacked taint pair's 128 get 2 CTAs each, with their tiles in shared
    memory (8 slots a lane where a CTA has an SM to itself, 4 where two
    share one); ba_10000's padded tiles fit no cluster, so they stay in
    L2 with the state over 8 CTAs; every V of the one-CTA kernel's old
    limit (29,056) is taken, and a state that fits no cluster is
    refused."""
    P = er_mod.K1Plan
    assert er_mod.k1_plan(64, 1000, 14) == P(2, 500, True, 8)
    assert er_mod.k1_plan(128, 1000, 14) == P(2, 500, True, 4)
    assert er_mod.k1_plan(200, 1000, 14) == P(1, 1000, True, 4)
    assert er_mod.k1_plan(16, 10000, 277) == P(8, 1252, False, 8)
    for V, D in ((29056, 1024), (29056, 1), (20000, 14)):
        plan = er_mod.k1_plan(1, V, D)
        assert plan.smem_bytes(D) <= er_mod._SMEM_BYTES
        assert plan.rows_cap * plan.size >= V
    assert er_mod.k1_plan(1, 20000, 14).tiles
    with pytest.raises(ValueError, match="no second path"):
        er_mod.k1_plan(1, er_mod.max_nodes() + 64, 1)


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


# ------------------------------------------------ K3's row map (card)
def _k3_coords(phi, delta, M):
    """The kernel's dual setup of permitted coordinates (csrc coord):
    (q, w, d, lo, hi), each as the oracle's dual_setup rounds it."""
    twoM = 2.0 * torch.clamp_min(M, 1e-12)
    return (phi - delta / twoM, 1.0 / twoM, delta,
            -delta - twoM * (1.0 - phi), -delta + twoM * phi)


def _k3_solve(phi, delta, M, cols, n, fb, G, kpl, n_iter=60):
    """K3's solve_row<G, kpl> for a batch of rows: lane t of the group
    holds compacted coordinates t, t+G, ... (cols [rows, G·kpl], -1 past
    n); a lane sums its registers in order, then the group's xor
    butterfly.  Returns (values [rows, G·kpl], one-hot column or -1)."""
    live = cols >= 0
    ridx = torch.arange(cols.shape[0])[:, None]
    c = torch.where(live, cols, 0)
    q, w, d, lo, hi = _k3_coords(phi[ridx, c], delta[ridx, c], M[ridx, c])
    q = torch.where(live, q, -ref.BIG)
    w = torch.where(live, w, 0.0)
    d = torch.where(live, d, float("inf"))
    lo = torch.where(live, lo, ref.BIG).amin(-1, keepdim=True)
    hi = torch.where(live, hi, -ref.BIG).amax(-1, keepdim=True)
    lanes = torch.arange(G)

    def group_sum(v):                       # [rows, G·kpl] -> [rows, 1]
        v = v.reshape(-1, kpl, G)
        acc = torch.zeros_like(v[:, 0])
        for r in range(kpl):
            acc = acc + v[:, r]
        off = G // 2
        while off:
            acc = acc + acc[:, lanes ^ off]
            off //= 2
        return acc[:, :1]

    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        up = group_sum(torch.clamp_min(q - mid * w, 0.0)) > 1.0
        lo2, hi2 = torch.where(up, mid, lo), torch.where(up, hi, mid)
        if torch.equal(lo2, lo) and torch.equal(hi2, hi):
            break
        lo, hi = lo2, hi2
    v = torch.clamp_min(q - (0.5 * (lo + hi)) * w, 0.0)
    v = torch.where(v > ref.SNAP_TOL, v, 0.0)
    s = group_sum(v)
    vals = torch.where(live, v / torch.clamp_min(s, 1e-30), 0.0)
    # first argmin of (d, column) over the compacted lanes, then the
    # first blocked column where no permitted d is below BIG
    key = torch.where(live, cols, 1 << 30)
    dm = d.amin(-1, keepdim=True)
    jm = torch.where(d == dm, key, 1 << 30).amin(-1)
    dm = dm[:, 0]
    use_fb = (fb < phi.shape[1]) & ((dm > ref.BIG) | ((dm == ref.BIG)
                                                      & (fb < jm)))
    jm = torch.where(use_fb, fb, jm)
    return vals, torch.where(s[:, 0] > 0.0, -1, jm)


def _k3_transcription(phi, delta, M, perm, B):
    """A transcription of K3 (`csrc/simplex_project.cu`): warps take
    batches of B rows; each row's permitted columns are compacted in
    column order; a row with n > 32 of them is solved by the whole warp
    (kpl = min(⌈K/32⌉, 16) registers a lane; a row past 32·kpl is
    streamed, the same sums in the same order as ⌈n/32⌉ registers), the
    others class by class on groups of G = 4, 8, 16 or 32 lanes, 32/G
    rows a pass.  Returns (out, schedule): schedule lists (warp, G,
    pass, group, row) of every row solved."""
    R, K = phi.shape
    kpl = min(16, -(-K // 32))
    n_of = perm.sum(-1)
    sched = []
    for wp, r0 in enumerate(range(0, R, B)):
        rows = list(range(r0, min(r0 + B, R)))
        sched += [(wp, 32, 0, 0, i) for i in rows if n_of[i] > 32]
        for G in (4, 8, 16, 32):
            cls = [i for i in rows if 0 < n_of[i] <= 32
                   and max(4, 1 << (int(n_of[i]) - 1).bit_length()) == G]
            sched += [(wp, G, k // (32 // G), k % (32 // G), i)
                      for k, i in enumerate(cls)]
    out = torch.zeros(R, K)
    kpl = max([kpl] + [-(-int(n) // 32) for n in n_of])
    for G, kp in ((4, 1), (8, 1), (16, 1), (32, 1), (32, kpl)):
        rows = [i for _, g, _, _, i in sched if g == G
                and (kp > 1) == (n_of[i] > 32)]
        if not rows:
            continue
        rows = torch.tensor(rows)
        cols = torch.full((len(rows), G * kp), -1)
        fb = torch.full((len(rows),), K)
        for a, i in enumerate(rows.tolist()):
            pc = perm[i].nonzero()[:, 0]
            # compacted coordinate p sits at lane p % G, register p // G
            cols[a, (pc.numel() and torch.arange(pc.numel()))] = pc
            bc = (~perm[i]).nonzero()[:, 0]
            fb[a] = int(bc[0]) if bc.numel() else K
        vals, jm = _k3_solve(phi[rows], delta[rows], M[rows], cols,
                             n_of[rows], fb, G, kp)
        for a, i in enumerate(rows.tolist()):
            if jm[a] >= 0:
                out[i, jm[a]] = 1.0
            else:
                live = cols[a] >= 0
                out[i, cols[a][live]] = vals[a][live]
    return out, sched


def _ba_rows(K, seed, dest_every=0):
    """[R, K] QP rows with ba_10000's pattern: out-degree 1-7 on most
    rows, the permitted slots a subset of the row's first `deg` columns
    (plus the local last column of data rows, K = 278), three hubs with
    40-250 permitted, fully blocked rows, and rows of vanishing scaling
    whose fallback one-hot takes the first of tied δ minima (or, with
    every permitted δ above BIG, the first blocked column)."""
    rng = np.random.default_rng(seed)
    R = 240
    deg = np.minimum(rng.geometric(0.3, R), 7)
    deg[[5, 77, 151]] = [45, 120, K - 1]
    perm = np.zeros((R, K), bool)
    for i in range(R):
        perm[i, :deg[i]] = rng.random(deg[i]) < (0.95 if deg[i] > 7
                                                  else 0.6)
    if K == 278:
        perm[:, -1] = True
    perm[10::37] = False                      # fully blocked rows
    if dest_every:
        perm[::dest_every] = False
    phi = rng.random((R, K)).astype(np.float32) * perm
    phi /= np.maximum(phi.sum(-1, keepdims=True), 1e-30)
    delta = (rng.random((R, K)) * 3).astype(np.float32)
    M = (rng.random((R, K)) * 2 + 0.25).astype(np.float32)
    tie = np.arange(3, R, 9)                  # one-hot to the first tie
    M[tie] = 1e-14
    for i in tie:
        pc = np.flatnonzero(perm[i])
        delta[i, pc] = 2.0
        delta[i, pc[-2:]] = 0.5
    M[4], delta[4] = 1e-14, 3e12              # every permitted δ > BIG
    perm[4, :3] = [True, False, True]
    phi[4] = 0.0
    return phi, delta, M, perm


@pytest.mark.parametrize("K,dest", [(278, 0), (277, 6)])
def test_k3_transcription_matches_oracle(K, dest):
    """The transcription of K3's compaction and sub-warp lane map solves
    every row with a permitted coordinate exactly once, in a group sized
    to its count (the whole warp above 32), and matches the plain version
    to 1e-6 on ba_10000-pattern data (K = 278) and result rows (K = 277,
    every sixth row a task's destination, fully blocked)."""
    phi, delta, M, perm = (torch.from_numpy(a) for a in _ba_rows(K, K,
                                                                 dest))
    want = ref.simplex_project_ref(phi, delta, M, perm)
    n_of = perm.sum(-1)
    assert int((n_of > 32).sum()) == 3 and bool((n_of == 0).any())
    # the fallback rows: ties to their first minimum, one past BIG
    assert want[4, 1] == 1.0
    tie = torch.arange(3, 240, 9)
    tie = tie[n_of[tie] > 1]
    assert bool((want[tie].argmax(-1) == torch.tensor(
        [int(perm[i].nonzero()[-2]) for i in tie])).all())
    B = sp_mod.rows_per_warp(K)
    assert B == 8
    got, sched = _k3_transcription(phi, delta, M, perm, B)
    solved = sorted(i for *_, i in sched)
    assert solved == torch.nonzero(n_of > 0)[:, 0].tolist()
    for wp, G, p, g, i in sched:
        assert i // B == wp and g < 32 // G
        n = int(n_of[i])
        assert G == (32 if n > 32 else max(4, 1 << (n - 1).bit_length()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert (got.numpy()[~perm.numpy() & (got.numpy() != 1.0)] == 0).all()


def test_k3_plan_takes_the_dense_width():
    """K3 plans the dense engine's rows [S·V, V+1] up to sw_1000's K =
    1001 (2 rows a warp, 16 registers a lane on the whole-warp route)
    with no ValueError, refuses a width whose plan a block's shared
    memory cannot hold, and its transcription, with rows of 1-15
    permitted (a node's out-edges and the local column), a row of 40
    (registers) and one of 600 (streamed) and fully blocked rows,
    matches the plain version to 1e-6."""
    plan = sp_mod.plan(1001)
    assert plan["rows_per_warp"] == 2 and plan["registers"] == 16
    assert plan["smem_bytes"] <= sp_mod.SMEM_LIMIT
    assert sp_mod.plan(12)["rows_per_warp"] == 16
    with pytest.raises(ValueError):
        sp_mod.plan(12000)
    rng = np.random.default_rng(1001)
    R, K = 40, 1001
    perm = np.zeros((R, K), bool)
    for i in range(R):
        perm[i, rng.choice(K - 1, rng.integers(0, 15), replace=False)] = True
    perm[:, -1] = True
    perm[7, rng.choice(K - 1, 39, replace=False)] = True
    perm[21, rng.choice(K - 1, 600, replace=False)] = True
    perm[::9] = False
    phi = rng.random((R, K)).astype(np.float32) * perm
    phi /= np.maximum(phi.sum(-1, keepdims=True), 1e-30)
    delta = (rng.random((R, K)) * 3).astype(np.float32)
    M = (rng.random((R, K)) * 2 + 0.25).astype(np.float32)
    phi, delta, M, perm = (torch.from_numpy(a) for a in (phi, delta, M,
                                                         perm))
    n_of = perm.sum(-1)
    assert int(n_of.max()) > 32 * plan["registers"]
    want = ref.simplex_project_ref(phi, delta, M, perm)
    got, sched = _k3_transcription(phi, delta, M, perm,
                                   plan["rows_per_warp"])
    assert sorted(i for *_, i in sched) == torch.nonzero(
        n_of > 0)[:, 0].tolist()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


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
