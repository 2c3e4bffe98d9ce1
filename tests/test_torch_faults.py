"""Fault injection on the port (`repro_torch.core.faults`) against the JAX
package's `repro.core.faults`.

The reference draws its faults from `jax.random`, which torch cannot
replay.  So the injectors are held to the reference on the reference's
own draws: `ref_draw_chain` recomputes them from a key with the splits
of `faults.py:176` and `:236`, and `ReferenceDraws` stands in for the
port's `draw_faults` to replay the reference's whole key chain through
the fused driver.  With the fresh marginal solve fed from the reference
too, `fault_step_begin` / `fault_step_end` equal the reference's
exactly (marginals, participation mask, poisoned φ, count), on the
sparse and the dense engine; a faulted run on abilene makes the
reference's accept / reject decisions with costs to rtol 2e-4.  Within
the port: `fault_plan=None` and an armed but inert plan are the
fault-free run bit for bit, p = 0.5 participation with staleness 3
converges, corruption poisons, and chunked runs resume bit for bit.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import faults as jfaults
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import faults as tfaults
from repro_torch.core import sgp
from test_torch_sgp import jax_net

torch.set_num_threads(1)

MG = ("rho_data", "rho_result", "delta_data", "delta_result")
_NETS = {}


def nets(name):
    """The port's scenario on the CPU, the reference's network holding the
    same arrays, and the port's SPT φ⁰."""
    if name not in _NETS:
        tnet = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
        _NETS[name] = (tnet, jax_net(tnet), tcore.spt_phi_sparse(tnet))
    return _NETS[name]


def jplan(plan):
    """The reference's FaultPlan with the port plan's fields."""
    return jfaults.FaultPlan(**dataclasses.asdict(plan))


def jtree(cls, x):
    """A reference dataclass holding a port dataclass's tensors."""
    return cls(*(jnp.asarray(t.numpy()) for t in sgp._fields(x)))


N_DRAWS = 12   # the iterations of a drawn chain (one compile for all)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _draw_chain(key, n, V, k, p_part, p_drop, p_cor):
    def one(key, _):
        key_new, k_part, k_lag, k_drop, k_cor = jax.random.split(key, 5)
        kf, ks, kv = jax.random.split(k_cor, 3)
        return key_new, (
            jax.random.randint(k_lag, (V,), 0, k + 1),
            jax.random.bernoulli(k_drop, p_drop, (V,)),
            jax.random.bernoulli(k_part, p_part, (1, V)),
            jax.random.bernoulli(kf, p_cor),
            jax.random.uniform(ks), jax.random.uniform(kv))
    return jax.lax.scan(one, key, None, length=n)[1]


def ref_draw_chain(key, plan, V, n=N_DRAWS) -> list:
    """The reference's draws of `n` iterations from fault key `key`, split
    as its `fault_step_begin` and `fault_step_end` split the key each
    iteration (`faults.py:176`, `:236`; an unarmed injector's draw is
    unused).  Returns [(lag, drop, part, fire, u_s, u_v)] as numpy."""
    f32 = np.float32
    out = _draw_chain(
        key, n, V, plan.staleness_k,
        f32(1.0 if plan.participation_p is None else plan.participation_p),
        f32(plan.dropout_p or 0.0), f32(plan.corrupt_p or 0.0))
    out = [np.array(x) for x in out]
    return [tuple(x[i] for x in out) for i in range(n)]


def port_draws(d) -> tfaults.FaultDraws:
    lag, drop, part, fire, u_s, u_v = (np.array(x) for x in d)
    return tfaults.FaultDraws(
        lag=torch.as_tensor(lag.astype(np.int64)),
        drop=torch.as_tensor(drop.astype(bool)),
        part=torch.as_tensor(part.astype(bool)),
        fire=torch.as_tensor(fire.astype(bool)),
        u_s=torch.as_tensor(u_s.astype(np.float32)),
        u_v=torch.as_tensor(u_v.astype(np.float32)))


class ReferenceDraws:
    """`faults.draw_faults` handing out the reference's draws of a chain,
    one iteration a call (the port's generator is left untouched)."""

    def __init__(self, chain):
        self.chain, self.calls = chain, 0

    def __call__(self, gen, plan, S, V):
        d = self.chain[self.calls]
        self.calls += 1
        return port_draws(d)


@functools.partial(jax.jit, static_argnums=(4, 5))
def ref_inject(net, phi, fl, fs, plan, method, nbrs, phi_new, fresh):
    """The reference's injectors around one step, on its own draws, with
    `fresh` as the iterate's marginal solve."""
    with mock.patch.object(jfaults, "compute_marginals",
                           lambda *a, **k: fresh):
        mg, pmask, k_cor, fs_mid = jfaults.fault_step_begin(
            net, phi, fl, fs, plan, method, nbrs, None, None)
    phi_out, fs_new = jfaults.fault_step_end(net, phi_new, k_cor, plan,
                                             fs_mid, nbrs=nbrs)
    return mg, pmask, phi_out, fs_new


def assert_same(got, want, label):
    """Bit for bit, NaN where NaN."""
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=label)


# ---------------------------------------------------------------- tests
def test_fault_plan_and_draws():
    """The plan is hashable and validated as the reference's; the draws
    take every field every iteration in a fixed order, so arming an
    injector shifts no other's stream; `fault_state_specs` names, field
    by field, the task dimension the reference's PartitionSpecs shard."""
    a = tfaults.FaultPlan(participation_p=0.5, staleness_k=3)
    assert a == tfaults.FaultPlan(participation_p=0.5, staleness_k=3)
    assert {a: 1}[tfaults.FaultPlan(participation_p=0.5, staleness_k=3)]
    for bad in ({"staleness_k": -1}, {"corrupt_p": 0.1,
                                      "corrupt_mode": "zero"}):
        with pytest.raises(ValueError):
            tfaults.FaultPlan(**bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlan(**bad)
    for plan in (tfaults.FaultPlan(), tfaults.FaultPlan(staleness_k=1),
                 tfaults.FaultPlan(dropout_p=0.0)):
        assert plan.stale_marginals == jplan(plan).stale_marginals
    one = tfaults.draw_faults(torch.Generator().manual_seed(4),
                              tfaults.FaultPlan(participation_p=0.5), 3, 11)
    all_ = tfaults.draw_faults(
        torch.Generator().manual_seed(4),
        tfaults.FaultPlan(participation_p=0.5, staleness_k=2, dropout_p=0.3,
                          corrupt_p=0.5), 3, 11)
    assert torch.equal(one.part, all_.part) and torch.equal(one.u_s,
                                                            all_.u_s)
    assert int(all_.lag.max()) <= 2 and not bool(one.drop.any())
    def task_dim(spec):
        return None if "tasks" not in tuple(spec) else \
            tuple(spec).index("tasks")
    for plan in (a, tfaults.FaultPlan(dropout_p=0.2, corrupt_p=0.1),
                 tfaults.FaultPlan(staleness_k=2, dropout_p=0.0),
                 tfaults.FaultPlan()):
        got = tfaults.fault_state_specs(plan, "tasks")
        want = jfaults.fault_state_specs(jplan(plan), "tasks")
        assert got.gen is None and task_dim(want.rng) is None
        assert got.n_corrupt is None and task_dim(want.n_corrupt) is None
        for g, w in ((got.ring, want.ring), (got.held, want.held)):
            assert (g is None) == (w is None)
            if g is not None:
                assert list(g) == [task_dim(x) for x in w]


@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_injectors_match_reference(method):
    """`fault_step_begin` and `fault_step_end` against the reference's on
    its own draws of one key, every injector armed, a ring of three
    distinct broadcasts and a hold: the marginals the propose reads, the
    participation mask, the new ring and hold, the poisoned candidate and
    the count, exactly.  Both read the port's fresh marginal solve (the
    marginals themselves are held to the reference's at tolerance by
    the flow-model tests)."""
    tnet, jnet, phi0 = nets("abilene")
    sparse = method == "sparse"
    p0 = phi0 if sparse else tcore.sparse_to_phi(phi0, tcore.build_neighbors(
        tnet.adj), tnet.V)
    st = tcore.init_run_state(tnet, p0, method=method)
    phis, fls = [], []
    for _ in range(5):
        phis.append(st.phi)
        fls.append(st.flows)
        tcore.run_chunk(tnet, st, 1)
    nbrs = st.nbrs
    margs = [tcore.compute_marginals(tnet, p, f, method, nbrs=nbrs,
                                     slot_F=sparse)
             for p, f in zip(phis, fls)]
    ring = [np.stack([getattr(m, f).numpy() for m in margs[1:4]])
            for f in MG]
    held = [getattr(margs[4], f).numpy() for f in MG]
    plan = tfaults.FaultPlan(participation_p=0.5, staleness_k=2,
                             dropout_p=0.4, corrupt_p=1.0)
    key = jax.random.PRNGKey(7)
    jphi_cls = jcore.PhiSparse if sparse else jcore.Phi
    jfs = jfaults.FaultState(rng=key, ring=tuple(map(jnp.asarray, ring)),
                             held=tuple(map(jnp.asarray, held)),
                             n_corrupt=jnp.asarray(2, jnp.int32))
    mg_ref, pmask_ref, phi_ref, fs_ref = ref_inject(
        jnet, jtree(jphi_cls, phis[0]), jtree(jcore.FlowsCarry, fls[0]),
        jfs, jplan(plan), method,
        jcore.build_neighbors(jnet.adj) if sparse else None,
        jtree(jphi_cls, phis[4]), jtree(jcore.Marginals, margs[0]))
    draws = port_draws(ref_draw_chain(key, plan, tnet.V)[0])
    assert 0 < int(draws.drop.sum()) < tnet.V and bool(draws.fire)
    assert {int(x) for x in draws.lag} == {0, 1, 2}
    fs = convert.fault_state_from_numpy(ring, held, 2, device="cpu")
    mg, pmask, fs_mid = tfaults.fault_step_begin(
        tnet, phis[0], fls[0], fs, plan, draws, method, nbrs)
    phi_out, fs_new = tfaults.fault_step_end(tnet, phis[4], draws, plan,
                                             fs_mid, nbrs)
    for f in MG + ("Dp", "Cp"):
        assert_same(getattr(mg, f), getattr(mg_ref, f), f"{method} mg.{f}")
    assert_same(pmask, pmask_ref, "participation")
    for k in range(4):
        assert_same(fs_new.ring[k], fs_ref.ring[k], f"ring {k}")
        assert_same(fs_new.held[k], fs_ref.held[k], f"held {k}")
    assert int(fs_new.n_corrupt) == int(fs_ref.n_corrupt) == 3
    for got, want in zip(sgp._fields(phi_out), jax.tree.leaves(phi_ref)):
        assert_same(got, want, f"{method} poisoned φ")
    assert int(sum(torch.isnan(t).sum() for t in sgp._fields(phi_out))) \
        >= 2


def test_faulted_trajectory_matches_reference(monkeypatch):
    """12 iterations on abilene under participation 0.5, staleness 2 and
    dropout 0.2 with the reference's draws fed in: the accept / reject
    decisions of `repro.core.run` and its costs to rtol 2e-4."""
    tnet, jnet, phi0 = nets("abilene")
    plan = tfaults.FaultPlan(participation_p=0.5, staleness_k=2,
                             dropout_p=0.2)
    key = jax.random.PRNGKey(3)
    _, want = jcore.run(jnet, jtree(jcore.PhiSparse, phi0), n_iters=12,
                        method="sparse", fault_plan=jplan(plan),
                        fault_rng=key)
    feed = ReferenceDraws(ref_draw_chain(key, plan, tnet.V))
    monkeypatch.setattr(tfaults, "draw_faults", feed)
    _, got = tcore.run(tnet, phi0, n_iters=12, method="sparse",
                       fault_plan=plan)
    assert feed.calls == 12
    assert got["n_rejected"] == want["n_rejected"]
    assert len(got["costs"]) == len(want["costs"])
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=2e-4)
    assert got["n_corrupt"] == want["n_corrupt"] == 0


def test_inert_plans_are_fault_free_bitwise():
    """`fault_plan=None` and a plan armed at inert values (participation
    1.0, dropout 0.0 — which solves the marginals outside the propose —
    and corruption 0.0) walk the fault-free trajectory bit for bit."""
    tnet, _, phi0 = nets("abilene")
    pa, ha = tcore.run(tnet, phi0, n_iters=20, method="sparse")
    for plan in (None, tfaults.FaultPlan(participation_p=1.0, dropout_p=0.0,
                                         corrupt_p=0.0)):
        pb, hb = tcore.run(tnet, phi0, n_iters=20, method="sparse",
                           fault_plan=plan)
        assert hb["costs"] == ha["costs"]
        assert hb["n_rejected"] == ha["n_rejected"]
        assert all(torch.equal(a, b) for a, b in zip(sgp._fields(pa),
                                                     sgp._fields(pb)))
        assert hb.get("n_corrupt", 0) == 0


def test_zero_participation_freezes_the_iterate():
    tnet, _, phi0 = nets("abilene")
    phi, _ = tcore.run(tnet, phi0, n_iters=6, method="sparse",
                       fault_plan=tfaults.FaultPlan(participation_p=0.0))
    assert all(torch.equal(a, b) for a, b in zip(sgp._fields(phi),
                                                 sgp._fields(phi0)))


@pytest.mark.parametrize("name", ["abilene", "fog"])
def test_partial_participation_stale_converges(name):
    """p = 0.5 participation with staleness 3 reaches within 1 % of the
    synchronous final cost with twice the budget (the paper's
    asynchronous updating, the reference's bar)."""
    tnet, _, phi0 = nets(name)
    _, hs = tcore.run(tnet, phi0, n_iters=30, method="sparse")
    _, hf = tcore.run(tnet, phi0, n_iters=60, method="sparse",
                      fault_plan=tfaults.FaultPlan(participation_p=0.5,
                                                   staleness_k=3),
                      fault_rng=torch.Generator().manual_seed(2))
    assert hf["final_cost"] <= 1.01 * hs["final_cost"]


def test_corruption_poisons_an_unguarded_run():
    """corrupt_p = 1.0 and no guards: the poison lands after the cost was
    measured, so the driver accepts it and ends with a poisoned φ; "inf"
    mode poisons with infinities and no NaN."""
    tnet, _, phi0 = nets("abilene")
    phi, hist = tcore.run(tnet, phi0, n_iters=20, method="sparse",
                          fault_plan=tfaults.FaultPlan(corrupt_p=1.0))
    assert hist["n_corrupt"] >= 1
    assert not all(bool(torch.isfinite(t).all()) for t in sgp._fields(phi))
    phi, hist = tcore.run(tnet, phi0, n_iters=5, method="sparse",
                          fault_plan=tfaults.FaultPlan(corrupt_p=1.0,
                                                       corrupt_mode="inf"))
    flat = torch.cat([t.reshape(-1) for t in sgp._fields(phi)])
    assert hist["n_corrupt"] >= 1 and bool(torch.isinf(flat).any())
    assert not bool(torch.isnan(flat).any())


def test_fault_generator_leaves_the_masks_alone():
    """An inert faulted run with Theorem-2 masks draws the same masks as
    the fault-free one (the fault stream is a generator of its own): the
    same trajectory bit for bit and the same Theorem-2 generator state."""
    tnet, _, phi0 = nets("fog")
    out = []
    for plan in (None, tfaults.FaultPlan(participation_p=1.0)):
        gen = torch.Generator().manual_seed(9)
        phi, hist = tcore.run(tnet, phi0, n_iters=15, method="sparse",
                              async_frac=0.3, rng=gen, fault_plan=plan)
        out.append((phi, hist, gen.get_state()))
    (pa, ha, ga), (pb, hb, gb) = out
    assert ha["costs"] == hb["costs"] and torch.equal(ga, gb)
    assert all(torch.equal(a, b) for a, b in zip(sgp._fields(pa),
                                                 sgp._fields(pb)))


def _whole_and_chunked(tnet, phi0, plan, n, chunk, seed):
    whole = tcore.init_run_state(tnet, phi0, method="sparse",
                                 fault_plan=plan,
                                 fault_rng=torch.Generator().manual_seed(seed))
    tcore.run_chunk(tnet, whole, n)
    parts = tcore.init_run_state(tnet, phi0, method="sparse",
                                 fault_plan=plan,
                                 fault_rng=torch.Generator().manual_seed(seed))
    for _ in range(0, n, chunk):
        tcore.run_chunk(tnet, parts, chunk)
    return whole, parts


@pytest.mark.parametrize("case", ["faulted", "past_a_stop"])
def test_chunked_resume_bitwise(case):
    """The fault carry rides `RunState`: a faulted run in chunks is the
    whole run bit for bit.  Past a stop (unguarded corruption: every
    candidate after the poison is rejected until σ blows up) the frozen
    iterations drew nothing: the fault generator is rewound to where the
    whole run's stopped."""
    if case == "faulted":
        tnet, _, phi0 = nets("fog")
        plan = tfaults.FaultPlan(participation_p=0.7, staleness_k=2,
                                 dropout_p=0.1)
        whole, parts = _whole_and_chunked(tnet, phi0, plan, 12, 4, 5)
    else:
        tnet, _, phi0 = nets("abilene")
        plan = tfaults.FaultPlan(corrupt_p=1.0)
        whole, parts = _whole_and_chunked(tnet, phi0, plan, 35, 7, 0)
        assert whole.stopped and whole.it < 35
    assert whole.costs == parts.costs and whole.it == parts.it
    assert whole.n_rejected == parts.n_rejected
    for a, b in zip(sgp._fields(whole.phi), sgp._fields(parts.phi)):
        assert_same(a, b, case)
    fa, fb = whole.fault_state, parts.fault_state
    assert int(fa.n_corrupt) == int(fb.n_corrupt)
    assert torch.equal(fa.gen.get_state(), fb.gen.get_state())
    for a, b in zip(fa.ring or (), fb.ring or ()):
        assert torch.equal(a, b)


def test_callback_refused_under_faults():
    tnet, _, phi0 = nets("abilene")
    st = tcore.init_run_state(tnet, phi0, method="sparse",
                              fault_plan=tfaults.FaultPlan(
                                  participation_p=0.5))
    with pytest.raises(ValueError, match="callback"):
        tcore.run_chunk(tnet, st, 2, callback=lambda *a: None)
