"""The dynamic task pool on the port against the JAX package: `TaskPool`
admission (reject / queue / grow), `ChurnState` under a pool, the slot
helpers (`next_pow2`, `pad_tasks`, `pad_phi_sparse`, `seed_task_slot`,
`clear_task_slot`, `mask_inactive_slots`), `compute_marginals(active=)`
and the `active` mask through Algorithm 1's step, then task-churn
replays: fog_taskchurn against the reference's replay (stored in
`src/repro_torch/data/reference_replay.json`, see
tests/test_torch_replay.py) and, within the port, the fused stream bit
for bit the event loop under each admission policy.

The pool's bookkeeping and the churned networks are exact (numpy on
both sides); the helpers are exact; marginals agree to float32 rounding
(rtol 1e-6), with the inactive rows' ρ exactly 0.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import network as jnetwork
from repro_torch import convert
from repro_torch import core as tcore
from test_torch_sgp import jax_net
from test_torch_replay import (TAIL, assert_net_equal, check_against_golden,
                               golden, jax_event, jax_sparse, nets,
                               phi_equal, play_both, port_row)

torch.set_num_threads(1)

__all__ = ["golden"]       # the module-scoped fixture, shared


def _arrival(V, seed, dest=None):
    rng = np.random.RandomState(seed)
    row = np.zeros(V)
    row[rng.choice(V, size=2, replace=False)] = rng.uniform(0.3, 0.8, 2)
    return tcore.TaskArrive(row, dest=int(rng.randint(V)) if dest is None
                            else dest, a=float(rng.uniform(0.3, 0.9)))


def _pool_sequence(V, S):
    """Arrivals past capacity, departures and a re-arrival."""
    return [_arrival(V, 1), _arrival(V, 2), _arrival(V, 3),
            tcore.TaskDepart(1), _arrival(V, 4), tcore.TaskDepart(0),
            tcore.TaskDepart(S - 1), _arrival(V, 5)]


@pytest.mark.parametrize("policy", ["reject", "queue", "grow"])
def test_pool_and_churn_state_match_reference(policy):
    """Admission decisions, logs and the churned networks (rates,
    destinations, result ratios, weights, task types; padded when the
    pool grows) after every event, exactly."""
    tnet, _ = nets("abilene")
    S = tnet.S
    tpad = tcore.pad_tasks(tnet, S + 1, n_active=S)
    jpad = jcore.pad_tasks(nets("abilene")[1], S + 1, n_active=S)
    assert_net_equal(tpad, jpad, "pad_tasks")
    tpool = tcore.TaskPool(S, S_cap=S + 1, policy=policy)
    jpool = jcore.TaskPool(S, S_cap=S + 1, policy=policy)
    tst, jst = (tcore.ChurnState(tpad, pool=tpool),
                jcore.ChurnState(jpad, pool=jpool))
    for ev in _pool_sequence(tnet.V, S):
        kind = tst.apply(ev)
        assert kind == jst.apply(jax_event(ev))
        assert tst.last_task_repairs == jst.last_task_repairs
        assert_net_equal(tst.network(), jst.network(), f"{policy} {ev}")
        np.testing.assert_array_equal(tpool.active, jpool.active)
        assert (tpool.S_cap, tpool.ever_padded, len(tpool.queue)) == \
            (jpool.S_cap, jpool.ever_padded, len(jpool.queue))
        assert [dataclasses.asdict(a) for a in tpool.drain_log()] == \
            [dataclasses.asdict(a) for a in jpool.drain_log()]
    # the pool's state carries across as numpy fields
    back = convert.pool_from_numpy(
        tpool.active, tpool.policy, tpool.ever_padded,
        [convert.event_to_numpy(e) for e in tpool.queue])
    assert back.active_for_engine() is not None
    np.testing.assert_array_equal(back.active, tpool.active)
    with pytest.raises(ValueError, match="inactive slot"):
        tpool.release(S + 5)


def test_pool_helpers_exact():
    """next_pow2, pad_phi_sparse, seed_task_slot, clear_task_slot and
    mask_inactive_slots against the reference on a warm iterate."""
    for n in (0, 1, 2, 3, 5, 16, 17, 1000):
        assert tcore.next_pow2(n) == jcore.next_pow2(n)
    tnet, jnet = nets("abilene")
    nbrs = tcore.build_neighbors(tnet.adj)
    phi, _ = tcore.run(tnet, tcore.spt_phi_sparse(tnet, nbrs), n_iters=3,
                       method="sparse")
    jphi = jax_sparse(phi)
    spt = tcore.spt_result_slots(tnet, nbrs)
    jspt = jnetwork.spt_result_slots(jnet, jcore.build_neighbors(jnet.adj))
    np.testing.assert_array_equal(spt.numpy(), np.asarray(jspt))
    active = np.arange(tnet.S) % 3 != 1
    cases = [
        (tcore.pad_phi_sparse(phi, 16), jcore.pad_phi_sparse(jphi, 16)),
        (tcore.seed_task_slot(phi, 2, spt),
         jcore.seed_task_slot(jphi, 2, jspt)),
        (tcore.clear_task_slot(phi, 4), jcore.clear_task_slot(jphi, 4)),
        (tcore.mask_inactive_slots(phi, torch.as_tensor(active)),
         jcore.mask_inactive_slots(jphi, active))]
    for got, want in cases:
        for f in ("data", "local", "result"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    assert tcore.pad_phi_sparse(phi, tnet.S) is phi
    with pytest.raises(ValueError):
        tcore.pad_tasks(tnet, tnet.S - 1)


def _pool_net(name="abilene", free=3):
    tnet, _ = nets(name)
    S = tnet.S
    return tcore.pad_tasks(tnet, S, n_active=S - free), S - free


def test_marginals_active_matches_reference():
    """`compute_marginals(active=)`: the reference's values, the inactive
    rows' ρ exactly 0."""
    net, n_act = _pool_net()
    jnet = jax_net(net)
    active = np.arange(net.S) < n_act
    nbrs = tcore.build_neighbors(net.adj)
    phi = tcore.spt_phi_sparse(net, nbrs)
    fl = tcore.compute_flows(net, phi, "sparse", nbrs=nbrs)
    mg = tcore.compute_marginals(net, phi, fl, "sparse", nbrs=nbrs,
                                 active=torch.as_tensor(active))
    @jax.jit
    def reference(jnet, jphi, jnbrs, active):
        jfl = jcore.compute_flows(jnet, jphi, "sparse", nbrs=jnbrs)
        return jcore.compute_marginals(jnet, jphi, jfl, "sparse",
                                       nbrs=jnbrs, active=active)
    jmg = reference(jnet, jax_sparse(phi), jcore.build_neighbors(jnet.adj),
                    active)
    for f in ("rho_data", "rho_result"):
        got = getattr(mg, f).numpy()
        assert (got[~active] == 0.0).all()
        np.testing.assert_allclose(got, np.asarray(getattr(jmg, f)),
                                   rtol=1e-6, atol=1e-6)


def test_active_mask_freezes_inactive_rows():
    """Under a mask the inactive rows of φ are kept bit for bit and the
    run equals the unpadded one on the active tasks' cost; a pool built
    full (`active_for_engine()` None) is the plain engine bit for bit."""
    net, n_act = _pool_net()
    active = torch.arange(net.S) < n_act
    nbrs = tcore.build_neighbors(net.adj)
    phi0 = tcore.mask_inactive_slots(tcore.spt_phi_sparse(net, nbrs),
                                     active)
    st = tcore.init_run_state(net, phi0, method="sparse", nbrs=nbrs,
                              active=active)
    host = tcore.init_run_state(net, phi0, method="sparse", nbrs=nbrs,
                                active=active)
    tcore.run_chunk(net, st, 6)
    tcore.run_chunk(net, host, 6, driver="host")
    assert st.costs == host.costs and phi_equal(st.phi, host.phi)
    for f in ("data", "local", "result"):
        assert torch.equal(getattr(st.phi, f)[~active],
                           getattr(phi0, f)[~active])
    full = tcore.TaskPool(net.S, S_cap=net.S)
    assert full.active_for_engine() is None
    base, _ = nets("abilene")
    plain_phi, plain = tcore.run(base, tcore.spt_phi_sparse(base),
                                 n_iters=6, method="sparse")
    eng = tcore.ReplayEngine(base, pool=full)
    hist = eng.play(tcore.ChurnSchedule(()), tail_iters=6)
    assert hist["costs"] == plain["costs"]
    assert phi_equal(eng.phi, plain_phi)


def test_taskchurn_replay_matches_reference(golden):
    """fog_taskchurn: the event loop (invariants after every event, the
    inactive rows exactly inert; cold baseline) against the reference's
    replay, then the fused stream bit for bit."""
    net, pool, sched = port_row("fog_taskchurn")
    want = golden["fog_taskchurn"]
    seen = []

    def inert(rec, eng):
        act = torch.as_tensor(eng.pool.active)
        for f, fill in (("data", 0.0), ("local", 1.0), ("result", 0.0)):
            assert (getattr(eng.phi, f)[~act] == fill).all()
        seen.append(rec.kind)

    eng = tcore.ReplayEngine(net, pool=pool.clone())
    hist = eng.play(sched, tail_iters=TAIL, cold_baseline=True,
                    callback=inert)
    assert seen.count("task") == 4
    check_against_golden(hist, eng, want, "fog_taskchurn")
    for f in ("data", "local", "result"):
        np.testing.assert_allclose(getattr(eng.phi, f).numpy(),
                                   np.asarray(want["phi"][f], np.float32),
                                   atol=5e-4)
    play_both(net, sched, pool=pool)


@pytest.mark.parametrize("policy", ["queue", "grow"])
def test_pool_policies_stream_bitwise(policy):
    """Arrivals past capacity under "queue" (deferred, then dequeued into
    a freed slot) and "grow" (S grows: the stream breaks there and the
    step is captured anew), the stream bit for bit the event loop."""
    tnet, _ = nets("abilene")
    S = tnet.S
    net = tcore.pad_tasks(tnet, S + 1, n_active=S - 1)
    pool = tcore.TaskPool(S - 1, S_cap=S + 1, policy=policy)
    V = tnet.V
    sched = tcore.ChurnSchedule((
        (1, _arrival(V, 1)), (2, _arrival(V, 2)), (3, _arrival(V, 3)),
        (5, tcore.RateScale(1.1)), (6, tcore.TaskDepart(2)),
        (8, tcore.SourceRedraw(0, seed=3))))
    _, hist = play_both(net, sched, pool=pool)
    actions = [a.action for a in hist["admission_events"]]
    if policy == "queue":
        assert actions == ["admit", "admit", "queue", "dequeue"]
    else:
        assert actions == ["admit", "admit", "grow"]
        assert [r.kind for r in hist["records"]][:3] == \
            ["task", "task", "grow"]
