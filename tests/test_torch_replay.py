"""Churn replay on the port against the JAX package: the events,
schedules and `ChurnState` (`core/events.py`), the edge-slot repair
(`refeasibilize_sparse*`, `sanitize_phi_sparse`), the canned schedules
(`scenarios.churn_schedule`), `sgp_step`, and `ReplayEngine`
(`core/replay.py`) with `FusedStream.rebaseline`.

Schedules, churned networks and repairs are held to the reference
exactly (the same numpy draws and float32 operations; repairs to atol
1e-6).  Whole replays come from `src/repro_torch/data/
reference_replay.json`, the JAX `ReplayEngine` (host loop driver, cold
baseline on) on the CPU: a live reference replay compiles its step for
every topology, a few seconds each on one core.  The small rows
(fog_churn, abilene_churn, fog_taskchurn) hold the port's event loop to
the same records, accepted and rejected steps and warm / cold
iterations-to-target, costs to rtol 2e-4 and the final φ to atol 5e-4
(the main path's bound, ROADMAP.md §3); `chip_smoke.py`'s `replay`
phase holds the card to the full-size rows (sw_1000_churn,
ba_1000_churn bucketed, sw_1000_taskchurn).  Within the port the fused
stream is bit for bit the event loop, asynchronous replays included.
Written by

    PYTHONPATH=src python tests/test_torch_replay.py --write-golden [ROW ...]

(all rows: ~2.5 minutes on an 8-core CPU).
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import replay as jreplay
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import sgp
from test_torch_sgp import jax_net

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "data")
REPLAY = os.path.join(DATA, "reference_replay.json")
TAIL = 5
# golden row -> (scenario, bucketed, task churn); the first three are the
# card's (chip_smoke.py's `replay` phase), the rest the CPU tests'
GOLDEN_ROWS = {
    "sw_1000_churn": ("sw_1000", False, False),
    "ba_1000_churn": ("ba_1000", True, False),
    "sw_1000_taskchurn": ("sw_1000", False, True),
    "fog_churn": ("fog", False, False),
    "abilene_churn": ("abilene", False, False),
    "fog_taskchurn": ("fog", False, True),
}
SMALL = ("fog_churn", "abilene_churn", "fog_taskchurn")


def event_json(ev) -> dict:
    """An event as its type's name and its fields (arrays as lists)."""
    out = {"type": type(ev).__name__}
    for f in dataclasses.fields(ev):
        v = getattr(ev, f.name)
        out[f.name] = (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                       else v)
    return out


def record_json(rec) -> dict:
    return {"it": rec.it, "kind": rec.kind,
            "cost_before": float(rec.cost_before),
            "cost_after": float(rec.cost_after),
            "segment_costs": [float(c) for c in rec.segment_costs],
            "segment_iters": rec.segment_iters,
            "warm_iters": rec.warm_iters, "cold_iters": rec.cold_iters,
            "cold_final": (None if rec.cold_final is None
                           else float(rec.cold_final))}


def reference_replay(key):
    """The JAX package's replay of golden row `key`: its own scenario and
    schedule, the event loop on the host driver with the cold baseline."""
    scenario, bucketed, task = GOLDEN_ROWS[key]
    pool = None
    if task:
        net, pool = jcore.taskchurn_scenario(scenario)
        pool_json = {"n_active": pool.n_active, "S_cap": pool.S_cap,
                     "policy": pool.policy}
    else:
        net = jcore.make_scenario(jcore.TABLE_II[scenario])
        pool_json = None
    sched = jcore.churn_schedule(key, net)
    eng = jcore.ReplayEngine(net, loop_driver="host", bucketed=bucketed,
                             invariant_checks=False, pool=pool)
    hist = eng.play(sched, tail_iters=TAIL, cold_baseline=True)
    out = {"scenario": scenario, "bucketed": bucketed, "pool": pool_json,
           "tail_iters": TAIL,
           "schedule": [[t, event_json(ev)] for t, ev in sched.events],
           "records": [record_json(r) for r in hist["records"]],
           "costs": [float(c) for c in hist["costs"]],
           "final_cost": float(hist["final_cost"]),
           "n_iters": int(hist["n_iters"]),
           "admission_events": [dataclasses.asdict(a) for a in
                                hist["admission_events"]]}
    if key in SMALL:
        out["phi"] = {f: np.asarray(getattr(eng.phi, f)).tolist()
                      for f in ("data", "local", "result")}
    return out


def write_golden(keys=None, path=REPLAY):
    """The reference's replays of `keys` (all rows by default), added to
    `path` beside its other keys."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out["source"] = ("the JAX package's ReplayEngine (repro.core), "
                     "loop_driver='host', cold_baseline=True, on the CPU: "
                     "PYTHONPATH=src python tests/test_torch_replay.py "
                     "--write-golden")
    for key in keys or GOLDEN_ROWS:
        out[key] = reference_replay(key)
        print(key, out[key]["final_cost"], out[key]["n_iters"], flush=True)
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")


# ------------------------------------------------------------- helpers
_NETS = {}


def nets(name):
    """The port's scenario on the CPU and the reference's network holding
    the same arrays."""
    if name not in _NETS:
        tnet = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
        _NETS[name] = (tnet, jax_net(tnet))
    return _NETS[name]


def jax_event(ev):
    """The reference's event with the same fields as a port event."""
    kind, fields = convert.event_to_numpy(ev)
    return getattr(jcore, kind)(**fields)


def jax_sparse(phi):
    return jcore.PhiSparse(*(jnp.asarray(t.numpy()) for t in
                             (phi.data, phi.local, phi.result)))


def assert_events_equal(port_events, ref_events):
    assert len(port_events) == len(ref_events)
    for (t, ev), (tr, er) in zip(port_events, ref_events):
        assert t == tr and type(ev).__name__ == type(er).__name__
        for f in dataclasses.fields(ev):
            np.testing.assert_array_equal(np.asarray(getattr(ev, f.name)),
                                          np.asarray(getattr(er, f.name)))


def assert_net_equal(tnet, jnet, label=""):
    for f in ("adj", "dest", "r", "a", "w", "task_type"):
        np.testing.assert_array_equal(getattr(tnet, f).numpy(),
                                      np.asarray(getattr(jnet, f)),
                                      err_msg=f"{label} {f}")
    for c in ("link_cost", "comp_cost"):
        assert getattr(tnet, c).family == getattr(jnet, c).family
        np.testing.assert_array_equal(getattr(tnet, c).params.numpy(),
                                      np.asarray(getattr(jnet, c).params),
                                      err_msg=f"{label} {c}")


def phi_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(sgp._fields(a), sgp._fields(b)))


def assert_same_history(h0, h1):
    """Two replays of the port, bit for bit."""
    assert h0["costs"] == h1["costs"]
    assert h0["n_iters"] == h1["n_iters"]
    assert len(h0["records"]) == len(h1["records"])
    for r0, r1 in zip(h0["records"], h1["records"]):
        assert (r0.it, r0.kind, type(r0.event)) == \
            (r1.it, r1.kind, type(r1.event))
        assert (r0.cost_before, r0.cost_after) == \
            (r1.cost_before, r1.cost_after)
        assert r0.segment_costs == r1.segment_costs
        assert r0.segment_iters == r1.segment_iters
    # the stream stamps its window's admissions at the window's entry
    assert [dataclasses.replace(a, it=-1) for a in h0["admission_events"]] \
        == [dataclasses.replace(a, it=-1) for a in h1["admission_events"]]


def play_both(net, sched, tail_iters=TAIL, seed=None, **kw):
    """The event loop and the fused stream, bit for bit.  Returns the
    event loop's (engine, history)."""
    out = []
    for stream in (False, True):
        pool = kw.get("pool")
        opts = dict(kw, pool=pool.clone() if pool is not None else None)
        if seed is not None:
            opts["rng"] = torch.Generator().manual_seed(seed)
        eng = tcore.ReplayEngine(net, invariant_checks=not stream, **opts)
        out.append((eng, eng.play(sched, tail_iters=tail_iters,
                                  stream=stream)))
    (e0, h0), (e1, h1) = out
    assert_same_history(h0, h1)
    assert phi_equal(e0.phi, e1.phi)
    return out[0]


@pytest.fixture(scope="module")
def golden():
    with open(REPLAY) as f:
        return json.load(f)


def port_row(key):
    """The port's network, pool and canned schedule of golden row `key`
    (on the CPU)."""
    scenario, _, task = GOLDEN_ROWS[key]
    if task:
        net, pool = tcore.taskchurn_scenario(scenario, device="cpu")
    else:
        net, pool = nets(scenario)[0], None
    return net, pool, tcore.churn_schedule(key, net)


# a repaired iterate far up the queue cost's quadratic continuation
# (its cost above STEEP_FACTOR times where its segment ends): the step
# out of it turns on ulp-level differences of marginals of ~1e4, and
# one-ulp changes of the capacities move the reference's own cost there
# by up to 1.9 % and every later cost by up to 4.5e-4 (ROADMAP.md §3;
# `python tests/test_torch_replay.py --ulp-witness abilene_churn
# ba_1000_churn`); chip_smoke.py's `replay_check` uses the same rule
RTOL, STEEP_FACTOR, STEEP_RTOL, AFTER_STEEP_RTOL = 2e-4, 10.0, 1e-1, 1e-3


def steep_step(w) -> bool:
    seg = w["segment_costs"]
    return bool(seg) and w["cost_after"] > STEEP_FACTOR * seg[-1]


def check_against_golden(hist, eng, want, label):
    """A port replay against the reference's: the same events and
    segments with the same accepted and rejected steps, costs to RTOL
    (after a steep start, `steep_step`, to its bounds), the same warm /
    cold iterations-to-target and admissions."""
    recs = hist["records"]
    assert len(recs) == len(want["records"]), label
    assert hist["n_iters"] == want["n_iters"], label
    assert len(hist["costs"]) == len(want["costs"]), label
    n0 = len(want["costs"]) - sum(1 + len(w["segment_costs"])
                                  for w in want["records"])
    np.testing.assert_allclose(hist["costs"][:n0], want["costs"][:n0],
                               rtol=RTOL, err_msg=label)
    tol = RTOL
    for rec, w in zip(recs, want["records"]):
        assert (rec.it, rec.kind, rec.segment_iters) == \
            (w["it"], w["kind"], w["segment_iters"]), label
        assert len(rec.segment_costs) == len(w["segment_costs"]), label
        got = [rec.cost_before, rec.cost_after] + rec.segment_costs
        ref = [w["cost_before"], w["cost_after"]] + w["segment_costs"]
        for i, (a, b) in enumerate(zip(got, ref)):
            if i == 2 and steep_step(w):
                np.testing.assert_allclose(a, b, rtol=STEEP_RTOL,
                                           err_msg=label)
                tol = AFTER_STEEP_RTOL
            else:
                np.testing.assert_allclose(a, b, rtol=tol, err_msg=label)
        assert (rec.warm_iters, rec.cold_iters) == \
            (w["warm_iters"], w["cold_iters"]), label
        if w["cold_final"] is not None:
            np.testing.assert_allclose(rec.cold_final, w["cold_final"],
                                       rtol=RTOL, err_msg=label)
        # segment costs never rise
        assert all(b <= a for a, b in zip(rec.segment_costs,
                                          rec.segment_costs[1:])), label
    assert [dataclasses.asdict(a) for a in hist["admission_events"]] == \
        want["admission_events"], label


# ---------------------------------------------------------------- tests
def test_core_exports_reference_names():
    for name in ("ReplayEngine", "EventRecord", "check_feasible",
                 "check_invariants", "iters_to_target", "iters_or_budget",
                 "ChurnSchedule", "ChurnState", "TaskPool", "AdmissionEvent",
                 "random_schedule", "event_kind", "churn_schedule",
                 "taskchurn_scenario", "refeasibilize_sparse",
                 "refeasibilize_sparse_samegraph", "sanitize_phi_sparse",
                 "next_pow2", "pad_tasks", "pad_phi_sparse",
                 "seed_task_slot", "clear_task_slot", "mask_inactive_slots",
                 "sgp_step"):
        assert hasattr(tcore, name) and hasattr(jcore, name), name


@pytest.mark.parametrize("key", ["fog_churn", "abilene_churn",
                                 "sw_queue_churn", "fog_taskchurn"])
def test_canned_schedule_matches_reference(key):
    """The canned schedules draw the reference's events."""
    if key.endswith("_taskchurn"):
        tnet, _ = tcore.taskchurn_scenario(key[:-len("_taskchurn")],
                                           device="cpu")
        jnet = jax_net(tnet)
    else:
        tnet, jnet = nets(key[:-len("_churn")])
    assert_events_equal(tcore.churn_schedule(key, tnet).events,
                        jcore.churn_schedule(key, jnet).events)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_schedule_matches_reference(seed):
    """`random_schedule` draw for draw, its delivery probes included
    (with a task pool on seed 3)."""
    tnet, jnet = nets("abilene")
    kw = {}
    jkw = {}
    if seed == 3:
        tnet = tcore.pad_tasks(tnet, 16, n_active=8)
        jnet = jax_net(tnet)
        kw = {"pool": tcore.TaskPool(8, S_cap=16)}
        jkw = {"pool": jcore.TaskPool(8, S_cap=16)}
    got = tcore.random_schedule(tnet, 10, seed=seed, **kw)
    want = jcore.random_schedule(jnet, 10, seed=seed, **jkw)
    assert_events_equal(got.events, want.events)
    assert got.name == want.name


def test_churn_state_network_matches_reference():
    """The churned network after every event, field for field, on the
    canned fog schedule and a random one with a destination re-draw,
    a rate set and a source re-draw onto a failed node's neighbours."""
    tnet, jnet = nets("fog")
    events = list(tcore.churn_schedule("fog_churn", tnet).events)
    events += list(tcore.random_schedule(tnet, 8, seed=5).events)
    events += [(0, tcore.DestRedraw(2, seed=4)),
               (0, tcore.NodeFail(tcore.churn_hub(tnet))),
               (0, tcore.RateSet(np.linspace(0.0, 1.0, tnet.V), task=1)),
               (0, tcore.SourceRedraw(3, seed=8))]
    tst, jst = tcore.ChurnState(tnet), jcore.ChurnState(jnet)
    for k, (_, ev) in enumerate(events):
        assert tst.apply(ev) == jst.apply(jax_event(ev))
        cur = tst.network()
        assert cur.adj.device == tnet.device
        assert_net_equal(cur, jst.network(), f"event {k} {ev}")
    c = tst.clone()
    c.apply(tcore.RateScale(2.0))
    assert not np.array_equal(c.r, tst.r)


def _warm(name, n=6):
    tnet, _ = nets(name)
    nbrs = tcore.build_neighbors(tnet.adj)
    st = tcore.init_run_state(tnet, tcore.spt_phi_sparse(tnet, nbrs),
                              method="sparse", nbrs=nbrs)
    tcore.run_chunk(tnet, st, n)
    return st.phi, nbrs


def test_refeasibilize_sparse_matches_reference():
    """Hub failure, link cut, recovery and restore on fog's warm iterate:
    the port's repair against the reference's (atol 1e-6, the same new
    tiles), and the same-graph repair bit for bit the full one."""
    tnet, jnet = nets("fog")
    phi, nbrs = _warm("fog")
    sched = tcore.churn_schedule("fog_churn", tnet)
    tst, jst = tcore.ChurnState(tnet), jcore.ChurnState(jnet)
    tphi, jphi = phi, jax_sparse(phi)
    tnb, jnb = nbrs, jcore.build_neighbors(jnet.adj)
    for _, ev in sched.events[1:4]:           # fail, cut, recover
        tst.apply(ev)
        jst.apply(jax_event(ev))
        tphi, tnb = tcore.refeasibilize_sparse(tst.network(), tphi, tnb)
        jphi, jnb = jcore.refeasibilize_sparse(jst.network(), jphi, jnb)
        np.testing.assert_array_equal(tnb.out_nbr.numpy(),
                                      np.asarray(jnb.out_nbr))
        for f in ("data", "local", "result"):
            np.testing.assert_allclose(getattr(tphi, f).numpy(),
                                       np.asarray(getattr(jphi, f)),
                                       atol=1e-6, err_msg=f"{ev} {f}")
    # routing churn on the unchanged graph: samegraph ≡ full, bit for bit
    tst.apply(tcore.DestRedraw(1, seed=13))
    cur = tst.network()
    rebuild = torch.arange(cur.S) == 1
    full, nb2 = tcore.refeasibilize_sparse(cur, tphi, tnb,
                                           rebuild_tasks=rebuild)
    assert nb2 is tnb                         # memoized: the same tiles
    fast = tcore.refeasibilize_sparse_samegraph(
        cur, tphi, tnb, rebuild_tasks=rebuild,
        spt_sp=tcore.spt_result_slots(cur, tnb))
    assert phi_equal(full, fast)


def test_sanitize_phi_sparse_matches_reference():
    phi, nbrs = _warm("abilene", 3)
    data = phi.data.clone()
    data[0, 0, 0] = float("nan")
    data[1, 2, :] = -0.5
    result = phi.result.clone()
    result[2, 3, 0] = float("inf")
    bad = tcore.PhiSparse(data, phi.local * 0.5, result)
    got = tcore.sanitize_phi_sparse(bad, nbrs)
    want = jax.jit(jcore.sanitize_phi_sparse)(
        jax_sparse(bad), jcore.build_neighbors(nets("abilene")[1].adj))
    for f in ("data", "local", "result"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6)


def test_zero_event_replay_is_bitwise_run():
    tnet, _ = nets("abilene")
    phi0 = tcore.spt_phi_sparse(tnet)
    want_phi, want = tcore.run(tnet, phi0, n_iters=10, method="sparse")
    eng = tcore.ReplayEngine(tnet, phi0=phi0)
    hist = eng.play(tcore.ChurnSchedule((), name="empty"), tail_iters=10)
    assert hist["costs"] == want["costs"]
    assert phi_equal(eng.phi, want_phi)


@pytest.mark.parametrize("key", ["fog_churn", "abilene_churn"])
def test_replay_matches_reference(golden, key):
    """The event loop with invariant checks after every event and the
    cold baseline, on the reference's replay (golden rows)."""
    net, pool, sched = port_row(key)
    want = golden[key]
    assert_events_equal(
        sched.events, convert.schedule_from_numpy(
            [(t, e["type"], e) for t, e in want["schedule"]]).events)
    eng = tcore.ReplayEngine(net, pool=pool)
    hist = eng.play(sched, tail_iters=TAIL, cold_baseline=True)
    check_against_golden(hist, eng, want, key)
    for f in ("data", "local", "result"):
        np.testing.assert_allclose(getattr(eng.phi, f).numpy(),
                                   np.asarray(want["phi"][f], np.float32),
                                   atol=5e-4, err_msg=f"{key} phi.{f}")


@pytest.mark.parametrize("name", ["fog", "abilene"])
def test_stream_bitwise_on_canned_churn(name):
    """The fused stream is the event loop bit for bit (costs, final φ,
    segmentation) on the canned schedule."""
    tnet, _ = nets(name)
    play_both(tnet, tcore.churn_schedule(f"{name}_churn", tnet))


def _mixed_schedule(net):
    """Same-graph events with a tie, a destination re-draw and one
    topology break."""
    return tcore.ChurnSchedule((
        (2, tcore.RateScale(1.3)),
        (4, tcore.SourceRedraw(1, seed=7)),
        (4, tcore.DestRedraw(0, seed=3)),         # tie: zero-length segment
        (6, tcore.RateScale(0.8, task=2)),
        (8, tcore.NodeFail(tcore.churn_hub(net))),  # stream break
        (11, tcore.RateScale(1.1)),
        (13, tcore.DestRedraw(2, seed=9)),
    ), name="mixed")


def test_stream_bitwise_mixed_tie_and_async():
    """A tie, destination re-draws and a topology break, synchronous and
    with Theorem-2 masks (async_frac 0.3, each segment's generator
    derived from the engine's seed), bit for bit; the tied event's
    segment is empty."""
    tnet, _ = nets("fog")
    sched = _mixed_schedule(tnet)
    _, hist = play_both(tnet, sched)
    tie = [r for r in hist["records"] if r.it == 4]
    assert len(tie) == 2 and tie[0].segment_iters == 0 \
        and tie[0].segment_costs == []
    _, ahist = play_both(tnet, sched, seed=11,
                         run_opts={"async_frac": 0.3})
    assert ahist["costs"] != hist["costs"]      # the masks held rows back
    _, again = play_both(tnet, sched, seed=11, run_opts={"async_frac": 0.3})
    assert again["costs"] == ahist["costs"]


def test_rate_event_reaches_the_fused_stream():
    """A rate event's network reaches the buffers the stream's step reads
    (its captured graph, on the card): the costs after it follow the new
    rates, equal to the event loop's fresh state on the churned network,
    and the network the stream started from is left as it was."""
    tnet, _ = nets("abilene")
    r0 = tnet.r.clone()
    st = tcore.init_run_state(tnet, tcore.spt_phi_sparse(tnet),
                              method="sparse")
    stream = sgp.FusedStream(tnet, st)
    stream.advance(3)
    churned = dataclasses.replace(tnet, r=tnet.r * 1.5)
    stream.rebaseline(churned)
    stream.advance(4)
    segs = stream.finish()
    assert len(segs) == 2 and torch.equal(tnet.r, r0)
    ref = tcore.init_run_state(tnet, tcore.spt_phi_sparse(tnet),
                               method="sparse")
    tcore.run_chunk(tnet, ref, 3)
    warm = tcore.init_run_state(churned, ref.phi, method="sparse")
    assert segs[0]["cost_before"] == ref.costs[-1]
    assert segs[0]["cost_after"] == warm.costs[0]
    assert warm.costs[0] > 1.4 * ref.costs[-1]
    tcore.run_chunk(churned, warm, 4)
    assert st.costs == warm.costs and phi_equal(st.phi, warm.phi)
    with pytest.raises(ValueError, match="topology"):
        sgp.FusedStream(tnet, warm).rebaseline(dataclasses.replace(
            tnet, link_cost=tcore.Cost("queue", tnet.link_cost.params * 2)))


def test_topology_events_follow_the_adjacency():
    """A bucketed engine's tiles and buckets follow every topology event
    (the failed graph's differ), and the recovered, restored graph gets
    back the very tiles and buckets it started with (memoized by
    adjacency, with K2's cluster plans on them)."""
    tnet, _ = nets("fog")
    eng = tcore.ReplayEngine(tnet, bucketed=True, invariant_checks=False)
    nbrs0, buckets0 = eng.nbrs, eng.buckets
    sched = tcore.churn_schedule("fog_churn", tnet)
    seen = []
    for _, ev in sched.events[1:5]:           # fail, cut, recover, restore
        eng.apply_event(ev)
        eng.iterate(1)
        seen.append((eng.nbrs, eng.buckets))
        assert torch.equal(eng.nbrs.out_mask.sum(1),
                           eng.net.adj.sum(1).clamp_max(eng.nbrs.Dmax))
    assert seen[0][0] is not nbrs0 and seen[0][1] is not buckets0
    assert seen[-1][0] is nbrs0 and seen[-1][1] is buckets0
    tcore.check_invariants(eng.net, eng.phi, eng.nbrs)


def test_invariants_and_iteration_counts():
    """`check_feasible` tolerates a one-ulp negative data slot (as the
    reference), `iters_to_target`'s sentinel and `iters_or_budget`."""
    phi, nbrs = _warm("abilene", 2)
    tnet, _ = nets("abilene")
    data = phi.data.clone()
    i, j = torch.nonzero(nbrs.out_mask)[0].tolist()
    data[0, i, j] = -1e-9
    local = phi.local.clone()
    local[0, i, 0] += 1e-9
    tcore.check_feasible(tcore.PhiSparse(data, local, phi.result), nbrs,
                         dest=tnet.dest)
    tcore.check_invariants(tnet, phi, nbrs, n_loop_tasks=4)
    bad = phi.result.clone()
    bad[0, 0] = 0.3 * nbrs.out_mask[0]
    with pytest.raises(AssertionError):
        tcore.check_feasible(tcore.PhiSparse(phi.data, phi.local, bad),
                             nbrs)
    for costs, target in (([5.0, 4.0, 3.0], 3.5), ([5.0, 4.0], 1.0)):
        assert tcore.iters_to_target(costs, target) == \
            jreplay.iters_to_target(costs, target)
    assert tcore.iters_or_budget(-1, 7) == 8 == \
        jreplay.iters_or_budget(-1, 7)


def test_not_implemented_and_errors():
    """A zero-event replay on the task-sharded driver (a world of one) is
    `run_distributed` bit for bit, and its state resumes across a rate
    event; the options it cannot take are refused, as the reference
    refuses them."""
    tnet, _ = nets("abilene")
    eng = tcore.ReplayEngine(tnet, driver="distributed",
                             invariant_checks=False)
    phi0 = tcore.spt_phi_sparse(tnet)
    eng.play(tcore.ChurnSchedule(events=[]), tail_iters=8)
    _, h = tcore.run_distributed(tnet, phi0, n_iters=8, method="sparse")
    assert eng.costs == h["costs"]
    pd = tcore.init_distributed_state(tnet, phi0, method="sparse")
    tcore.run_distributed_chunk(pd, 8)
    for f in ("data", "local", "result"):
        assert torch.equal(getattr(eng.phi, f), getattr(pd.phi, f))
    rec = eng.rebaseline_rates(tnet.r.numpy() * 1.1, n_iters=3)
    assert rec.kind == "routing" and eng.total_iters == 11
    assert isinstance(eng.state, tcore.DistributedRunState)
    for kw in ({"driver": "distributed", "bucketed": True},
               {"driver": "distributed", "pool": tcore.TaskPool(10)},
               {"driver": "distributed", "run_opts": {"tol": 0.1}},
               {"mesh": object()}):
        with pytest.raises(ValueError):
            tcore.ReplayEngine(tnet, **kw)
    with pytest.raises(ValueError, match="rng"):
        tcore.ReplayEngine(tnet, run_opts={"async_frac": 0.2})
    with pytest.raises(ValueError, match="not options"):
        tcore.ReplayEngine(tnet, run_opts={"fault_plan": 1})
    eng = tcore.ReplayEngine(tnet, loop_driver="host",
                             invariant_checks=False)
    with pytest.raises(ValueError, match="host"):
        eng.play(tcore.churn_schedule("abilene_churn", tnet), stream=True)
    with pytest.raises(ValueError, match="cold_baseline"):
        tcore.ReplayEngine(tnet).play(
            tcore.churn_schedule("abilene_churn", tnet), stream=True,
            cold_baseline=True)


def test_rebaseline_rates():
    """The serving bridge's warm rebaseline: a `RateSet` event, repaired
    and re-baselined without re-solving from the SPT."""
    tnet, jnet = nets("abilene")
    eng = tcore.ReplayEngine(tnet)
    eng.iterate(4)
    r = tnet.r.numpy()[2] * 0.0
    r[[1, 5]] = 0.7
    rec = eng.rebaseline_rates(r, task=2, n_iters=3)
    assert rec.kind == "routing" and eng.records[-1] is rec
    assert rec.segment_iters == 3 and eng.total_iters == 7
    np.testing.assert_array_equal(eng.net.r[2].numpy(),
                                  r.astype(np.float32))


def test_sgp_step_matches_reference():
    """The public step on abilene from φ⁰ (sparse engine, κ = 1, the
    reference's defaults) against the reference's jitted `sgp_step`."""
    tnet, jnet = nets("abilene")
    nbrs = tcore.build_neighbors(tnet.adj)
    phi0 = tcore.spt_phi_sparse(tnet, nbrs)
    st = tcore.init_run_state(tnet, phi0, method="sparse", nbrs=nbrs)
    got, aux = tcore.sgp_step(tnet, phi0, st.consts, method="sparse",
                              nbrs=nbrs)
    jnbrs = jcore.build_neighbors(jnet.adj)
    jconsts = jcore.SGPConsts(*(jnp.asarray(t.numpy()) for t in
                                sgp._fields(st.consts)))
    want, jaux = jcore.sgp_step(jnet, jax_sparse(phi0), jconsts,
                                method="sparse", nbrs=jnbrs)
    np.testing.assert_allclose(float(aux["cost"]), float(jaux["cost"]),
                               rtol=1e-6)
    np.testing.assert_allclose(aux["flows"].F.numpy(),
                               np.asarray(jaux["flows"].F), rtol=1e-6,
                               atol=1e-7)
    for f in ("data", "local", "result"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5)
    # Algorithm 1's iteration (both drivers') proposes the same candidate
    out = sgp._sgp_step_flows_impl(tnet, phi0, st.flows, st.consts,
                                   method="sparse", nbrs=nbrs, kappa=1.0)
    assert phi_equal(out[0], got)


def ulp_witness(key="abilene_churn"):
    """How far one-ulp changes of the inputs move the reference's own
    replay of golden row `key` (a churn row): the largest relative change
    of a recorded cost (cost_before, cost_after, segment costs), and of
    the accepted costs in each segment, under the link capacities one ulp
    down, the compute capacities one ulp up, the rates one ulp up."""
    scenario, bucketed, _ = GOLDEN_ROWS[key]
    net = jcore.make_scenario(jcore.TABLE_II[scenario])
    sched = jcore.churn_schedule(key, net)

    def costs(n):
        eng = jcore.ReplayEngine(n, loop_driver="host", bucketed=bucketed,
                                 invariant_checks=False)
        return [[r.cost_before, r.cost_after] + r.segment_costs
                for r in eng.play(sched, tail_iters=TAIL)["records"]]

    def ulp(x, to):
        x = np.asarray(x)
        return jnp.asarray(np.where(x > 0, np.nextafter(
            x, np.float32(to)), x))

    base = costs(net)
    for label, n in (
            ("link capacities -1 ulp", dataclasses.replace(
                net, link_cost=jcore.Cost("queue", ulp(
                    net.link_cost.params, 0)))),
            ("compute capacities +1 ulp", dataclasses.replace(
                net, comp_cost=jcore.Cost("queue", ulp(
                    net.comp_cost.params, np.inf)))),
            ("rates +1 ulp", dataclasses.replace(net, r=ulp(net.r,
                                                             np.inf)))):
        moved = costs(n)
        per_seg = [max([0.0] + [abs(a - b) / abs(b) for a, b in
                                zip(m[2:], c[2:])])
                   for m, c in zip(moved, base)]
        print(key, label, "max", max(abs(a - b) / abs(b)
                                     for m, c in zip(moved, base)
                                     for a, b in zip(m, c)),
              "by segment", per_seg, flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--write-golden" in args:
        write_golden(args[args.index("--write-golden") + 1:] or None)
    if "--ulp-witness" in args:
        for key in args[args.index("--ulp-witness") + 1:] or \
                ["abilene_churn"]:
            ulp_witness(key)
