"""The SGP request router on the port (`repro_torch.serving.router`)
against the JAX package's `repro.serving.router`.

Both packages build the same router from the same pods, classes and
demand (the small routers of `tests/test_serving.py`) and are driven
alike.  Tolerances: plan and failover costs at rtol 2e-4 with the same
rejections, φ at atol 1e-4, the summary's cost at rtol 2e-4 and its
dispatch at atol 1e-4; `run_opts` refused with the same keys named;
the drift rebaseline, the pool's admissions, rejections, queueing and
departures (the same lists and slots) and `decide`'s argmax walk
exactly; `greedy_plan`'s assignment exactly and its cost at rtol 2e-4;
`RateEstimator` exactly.  Within the port: `plan(distributed=True)` at a
world of one is `plan()` bit for bit.  The file takes ~41 s under
`taskset -c 0` by pytest's clock, ~26 s of it the reference's compiles
(plan ~12 s, the failover's new graph ~9 s, the warm rebaseline ~5 s;
later routers of the same S reuse them, so the tests share them through
JAX's own caches).

    PYTHONPATH=src python tests/test_torch_router.py --write-golden

writes `src/repro_torch/data/reference_router.json`, the JAX router's
run at the full-size cluster `router_256` (plan, greedy, failover, drift
and admission) that `chip_smoke.py` holds the port to on the card.
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro_torch import core as tcore
from repro_torch import serving as tserving
from repro_torch.convert import phi_sparse_to_numpy, router_to_numpy
from repro_torch.serving.router import feed_steady, router_256

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "..", "src", "repro_torch", "data",
                      "reference_router.json")
RTOL = 2e-4
PHI_ATOL = 1e-4

PODS = ((30.0, 1.0), (20.0, 0.8), (40.0, 1.2))
CLASSES = {"chat": 1.5, "sum": 0.3}
DEMAND = np.array([[2.0, 1.0], [1.0, 2.0]])


def port_router(pods=PODS, classes=CLASSES, demand=DEMAND, n_frontends=2,
                class_slots=2, **kw):
    """The port's router on the CPU, with a task pool of two spare slots
    (S_cap 4) unless asked otherwise."""
    return tserving.RequestRouter([tserving.PodSpec(c, s) for c, s in pods],
                                  n_frontends, dict(classes), demand,
                                  device="cpu", class_slots=class_slots,
                                  **kw)


def routers(pods=PODS, classes=CLASSES, demand=DEMAND, n_frontends=2,
            class_slots=2, **kw):
    """The same router in both packages (the port's on the CPU), with a
    task pool of two spare slots (S_cap 4) unless asked otherwise: every
    case then shares the reference's compiled S = 4 step."""
    tr = port_router(pods, classes, demand, n_frontends, class_slots, **kw)
    kw["class_slots"] = class_slots
    jr = jserving.RequestRouter([jserving.PodSpec(c, s) for c, s in pods],
                                n_frontends, dict(classes), demand, **kw)
    return tr, jr


def check_plan(tr, jr, ts, js, label):
    """Costs, rejections, φ and the summary of two routers' last plan."""
    th, jh = tr.history, jr.history
    assert th["n_rejected"] == jh["n_rejected"], label
    assert len(th["costs"]) == len(jh["costs"]), label
    np.testing.assert_allclose(th["costs"], jh["costs"], rtol=RTOL,
                               err_msg=label)
    for got, want in zip(phi_sparse_to_numpy(tr.phi),
                         (jr.phi.data, jr.phi.local, jr.phi.result)):
        np.testing.assert_allclose(got, np.asarray(want), atol=PHI_ATOL,
                                   err_msg=label)
    np.testing.assert_allclose(ts["total_cost"], js["total_cost"],
                               rtol=RTOL, err_msg=label)
    np.testing.assert_allclose(ts["dispatch"], js["dispatch"],
                               atol=PHI_ATOL, err_msg=label)
    np.testing.assert_allclose(ts["pod_utilization"],
                               js["pod_utilization"], atol=PHI_ATOL,
                               err_msg=label)
    assert ts["residual"]["loop_free"] == js["residual"]["loop_free"]


@pytest.fixture(scope="module")
def planned():
    """Both small routers after plan(40), then a failover of the busiest
    pod (40 more): each summary as it was.  Their classes hold slots 0
    and 1 of a pool of four; the idle slots carry no traffic."""
    tr, jr = routers()
    out = {"plan": (tr.plan(n_iters=40), jr.plan(n_iters=40))}
    out["plan_state"] = (tr.history, jr.history,
                         phi_sparse_to_numpy(tr.phi),
                         tuple(np.asarray(x) for x in
                               (jr.phi.data, jr.phi.local, jr.phi.result)))
    out["decide"] = [(tr.decide(c, f), jr.decide(c, f))
                     for c in CLASSES for f in range(2)]
    out["greedy"] = (tr.greedy_plan(), jr.greedy_plan())
    victim = int(np.argmax(out["plan"][1]["dispatch"].sum(axis=0)))
    out["victim"] = victim
    out["failover"] = (tr.on_pod_failure(victim, n_iters=40),
                       jr.on_pod_failure(victim, n_iters=40))
    out["routers"] = (tr, jr)
    return out


def test_plan_matches_reference(planned):
    """plan(40): the sparse engine through the fused driver, from the
    nearest-pod φ⁰ on the feasibility-scaled network."""
    th, jh, tphi, jphi = planned["plan_state"]
    ts, js = planned["plan"]
    assert th["n_rejected"] == jh["n_rejected"]
    np.testing.assert_allclose(th["costs"], jh["costs"], rtol=RTOL)
    for got, want in zip(tphi, jphi):
        np.testing.assert_allclose(got, want, atol=PHI_ATOL)
    np.testing.assert_allclose(ts["total_cost"], js["total_cost"],
                               rtol=RTOL)
    np.testing.assert_allclose(ts["dispatch"], js["dispatch"],
                               atol=PHI_ATOL)
    np.testing.assert_allclose(ts["residual"]["theorem1"],
                               js["residual"]["theorem1"], atol=1e-4)
    assert ts["residual"]["loop_free"] and js["residual"]["loop_free"]


def test_router_network_matches_reference():
    """The cluster's network (adjacency, the feasibility-scaled
    capacities, rates, ratios, weights) and φ⁰, field for field."""
    tr, jr = routers()
    got = router_to_numpy(tr)
    for k in ("adj", "r", "a", "w", "dest"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jr.net, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got["link_params"],
                               np.asarray(jr.net.link_cost.params),
                               rtol=1e-6)
    np.testing.assert_allclose(got["comp_params"],
                               np.asarray(jr.net.comp_cost.params),
                               rtol=1e-6)
    np.testing.assert_array_equal(tr._phi_init.data.numpy(),
                                  np.asarray(jr._phi_init.data))
    assert tr.pod_nodes == jr.pod_nodes


def test_failover_matches_reference(planned):
    """on_pod_failure of the busiest pod: the sparse iterate repaired
    warm (`refeasibilize_sparse`) and 40 more iterations; no dispatch to
    the failed pod."""
    tr, jr = planned["routers"]
    ts, js = planned["failover"]
    check_plan(tr, jr, ts, js, "failover")
    assert ts["dispatch"][:, planned["victim"]].sum() < 1e-6


def test_decide_argmax_matches_reference(planned):
    """`decide`'s argmax walk, every class from every frontend (on the
    plan before the failover)."""
    for got, want in planned["decide"]:
        assert got == want


def test_greedy_plan_matches_reference(planned):
    tg, jg = planned["greedy"]
    np.testing.assert_array_equal(tg["assignment"], jg["assignment"])
    np.testing.assert_array_equal(tg["pod_load"], jg["pod_load"])
    np.testing.assert_allclose(tg["total_cost"], jg["total_cost"],
                               rtol=RTOL)
    assert tg["total_cost"] >= planned["plan"][0]["total_cost"]


def test_sampled_decide_serves_pods_phi_routes_to(planned):
    tr, _ = planned["routers"]
    share = planned["failover"][0]["dispatch"].sum(axis=0)
    rng = np.random.RandomState(0)
    picks = {tr.decide("sum", 1, rng=rng) for _ in range(64)}
    assert all(share[q] > 0.0 for q in picks)


def test_run_opts_rejected_loudly():
    """Unknown and wrapper-owned keys are refused, naming the same keys
    as the reference (the reference's list also names its
    `engine_impl` / `proj_impl` backends, which the port has not)."""
    tr, jr = routers()
    for opts, match in (({"bogus": 1}, "bogus"), ({"driver": "host"},
                                                  "driver")):
        with pytest.raises(ValueError, match=match) as te:
            tr.plan(n_iters=5, run_opts=opts)
        with pytest.raises(ValueError, match=match) as je:
            jr.plan(n_iters=5, run_opts=opts)
        if "supported keys" in str(je.value):
            tkeys = set(eval(str(te.value).split("supported keys: ")[1]))
            jkeys = set(eval(str(je.value).split("supported keys: ")[1]))
            assert tkeys == jkeys - {"engine_impl", "proj_impl"}
    for distributed in (False, True):
        with pytest.raises(ValueError, match="bogus"):
            tr.plan(n_iters=5, distributed=distributed,
                    run_opts={"bogus": 1})
    s = tr.plan(n_iters=10, run_opts={"tol": 0.0, "kappa": 0.0})
    assert s["residual"]["loop_free"]


def test_distributed_plan_is_plan():
    """plan(distributed=True) at a world of one: `run_distributed` on the
    in-process gloo world, bit for bit `plan()`."""
    a, b = port_router(), port_router()
    sa = a.plan(n_iters=25)
    sb = b.plan(n_iters=25, distributed=True)
    assert a.history["costs"] == b.history["costs"]
    assert a.history["n_rejected"] == b.history["n_rejected"]
    for x, y in zip(phi_sparse_to_numpy(a.phi), phi_sparse_to_numpy(b.phi)):
        np.testing.assert_array_equal(x, y)
    assert sa["total_cost"] == sb["total_cost"]


def _feed_both(tr, jr, rates, t0, **kw):
    t1 = feed_steady(tr, rates, t0=t0, **kw)
    assert feed_steady(jr, rates, t0=t0, **kw) == t1
    return t1


def test_drift_rebaseline_matches_reference():
    """Below the threshold nothing happens; chat at 1.5× on frontend 0
    drifts past it and folds in as ONE warm `RateSet` through the live
    `ReplayEngine`: the drift, the warm segment's costs and the
    re-anchored plan as the reference's."""
    tr, jr = routers()
    tr.plan(n_iters=30)
    jr.plan(n_iters=30)
    base = {n: DEMAND[i] for i, n in enumerate(CLASSES)}
    t = _feed_both(tr, jr, base, 0.0)
    assert tr.drift() == jr.drift() < 0.05
    assert not tr.maybe_rebaseline()["rebaselined"]
    up = dict(base, chat=base["chat"] * np.array([2.5, 1.0]))
    _feed_both(tr, jr, up, t)
    to = tr.maybe_rebaseline(threshold=0.25, n_iters=20)
    jo = jr.maybe_rebaseline(threshold=0.25, n_iters=20)
    assert to["rebaselined"] and jo["rebaselined"]
    assert to["drift"] == jo["drift"] > 0.25
    np.testing.assert_allclose(to["cost"], jo["cost"], rtol=RTOL)
    np.testing.assert_allclose(tr._live.costs, jr._live.costs, rtol=RTOL)
    assert tr.drift() == jr.drift()
    assert isinstance(tr._live, tcore.ReplayEngine)
    ts, js = tr.summary(), jr.summary()
    np.testing.assert_allclose(ts["total_cost"], js["total_cost"],
                               rtol=RTOL)
    assert ts["residual"]["loop_free"]


@pytest.mark.parametrize("policy", ["reject", "queue"])
def test_pool_admissions_match_reference(policy):
    """A task pool of 2 spare slots (S_cap 4): three unknown classes
    observed, two admitted warm as `TaskArrive`s into slots 2 and 3, the
    third rejected or queued; after the window empties the admitted
    classes depart (`TaskDepart`) and a queued one takes the freed slot;
    lists, slots, pool masks and costs as the reference's."""
    tr, jr = routers(admission_policy=policy)
    assert int(tr.net.S) == int(jr.net.S) == 4
    tr.plan(n_iters=20)
    jr.plan(n_iters=20)
    base = {"chat": np.array([1.0, 0.5]), "sum": np.array([0.5, 1.0])}
    extras = {f"job{i}": np.array([4.0, 0.0]) for i in range(3)}
    t = _feed_both(tr, jr, dict(base, **extras), 0.0, seconds=20.0,
                   a={"job0": 1.2, "job1": 0.4, "job2": 2.0})
    to = tr.maybe_rebaseline(threshold=1e9, n_iters=5)
    jo = jr.maybe_rebaseline(threshold=1e9, n_iters=5)
    assert to["admissions"] == jo["admissions"]
    assert len(to["admissions"]["admitted"]) == 2
    assert tr._dynamic == jr._dynamic
    np.testing.assert_array_equal(tr.pool.active, jr.pool.active)
    np.testing.assert_allclose(to["cost"], jo["cost"], rtol=RTOL)
    assert 0 <= tr.decide("job0", 0) < tr.P
    assert tr.decide("job0", 0) == jr.decide("job0", 0)
    # the window empties: the admitted classes depart, a queued one lands
    t += 500.0
    for r in (tr, jr):
        r.estimator.rates(t=t)
    to = tr.maybe_rebaseline(threshold=1e9, n_iters=5)
    jo = jr.maybe_rebaseline(threshold=1e9, n_iters=5)
    assert to["task_events"] == jo["task_events"]
    assert to["admissions"] == jo["admissions"]
    assert tr._dynamic == jr._dynamic
    np.testing.assert_array_equal(tr.pool.active, jr.pool.active)
    assert [(e.action, e.slot) for e in tr._live.admission_log] == \
        [(e.action, e.slot) for e in jr._live.admission_log]


def test_rate_estimator_matches_reference():
    """Random observe / ingest / rates / ensure_rows sequences, value for
    value."""
    rng = np.random.RandomState(5)
    te, je = tserving.RateEstimator(3, 2, 7.5), jserving.RateEstimator(
        3, 2, 7.5)
    t = 0.0
    for i in range(400):
        op = rng.randint(4)
        s, f, tok = rng.randint(3), rng.randint(2), float(rng.poisson(20))
        if op < 2:
            t += float(rng.exponential(0.3))
            te.observe(s, f, tok, t)
            je.observe(s, f, tok, t)
        elif op == 2:
            back = t - float(rng.uniform(0.0, 5.0))
            te.ingest(s, f, tok, back)
            je.ingest(s, f, tok, back)
        else:
            t += float(rng.exponential(1.0))
            np.testing.assert_array_equal(te.rates(t), je.rates(t))
        if i == 200:
            te.ensure_rows(5)
            je.ensure_rows(5)
            s = 4
        np.testing.assert_array_equal(te.rates(), je.rates())
    with pytest.raises(ValueError):
        te.observe(0, 0, 1.0, t - 1.0)


def test_unknown_class_without_pool_raises():
    tr = port_router(class_slots=0)
    with pytest.raises(ValueError):
        tr.observe("mystery", 0, 1.0, t=1.0)


# --------------------------------------------------------------- golden
ROUTER_ITERS = 150
DRIFT = {"class": "class0", "factor": 1.5, "new_class": "new",
         "new_rate": 1.0, "new_a": 1.0, "seconds": 60.0, "dt": 0.5,
         "threshold": 0.01, "n_iters": 30}


def drift_rates(spec) -> dict:
    """The drift step's steady rates: the planned demand, DRIFT's class
    scaled, and a new class at a flat rate at every frontend."""
    rates = {name: np.array(spec["demand"][m], dtype=np.float64)
             for m, name in enumerate(spec["classes"])}
    rates[DRIFT["class"]] = rates[DRIFT["class"]] * DRIFT["factor"]
    rates[DRIFT["new_class"]] = np.full(spec["n_frontends"],
                                        DRIFT["new_rate"])
    return rates


def write_golden(ulp: bool = False) -> dict:
    """The JAX router at `router_256`: plan(150), greedy_plan, the
    busiest pod's failover (150), then DRIFT (one class up, one new
    class admitted) through maybe_rebaseline.  ulp=True moves every link
    capacity up by one float32 ulp first and returns the run instead of
    writing it (the witness of how far rounding moves the reference's
    own run)."""
    spec = router_256()
    jr = jserving.RequestRouter(
        [jserving.PodSpec(p.capacity, p.speed) for p in spec["pods"]],
        spec["n_frontends"], spec["classes"], spec["demand"],
        class_slots=spec["class_slots"])
    if ulp:
        import dataclasses

        import jax.numpy as jnp
        from repro.core.costs import Cost as JCost
        caps = np.asarray(jr.net.link_cost.params, np.float32)
        jr.net = dataclasses.replace(jr.net, link_cost=JCost(
            "queue", jnp.asarray(np.nextafter(caps, np.float32(np.inf)))))
    out = {"command": "PYTHONPATH=src python tests/test_torch_router.py "
                      "--write-golden",
           "router": "router_256", "V": int(jr.net.V), "S": int(jr.net.S),
           "n_iters": ROUTER_ITERS, "drift_spec": DRIFT}

    def plan_record(s, hist):
        d = np.asarray(s["dispatch"])
        return {"costs": [float(c) for c in hist["costs"]],
                "n_rejected": int(hist["n_rejected"]),
                "total_cost": float(s["total_cost"]),
                "dispatch_share": (d.sum(0) / d.sum()).tolist(),
                "theorem1": float(s["residual"]["theorem1"]),
                "loop_free": bool(s["residual"]["loop_free"])}
    t0 = time.time()
    s = jr.plan(n_iters=ROUTER_ITERS)
    out["plan"] = plan_record(s, jr.history)
    g = jr.greedy_plan()
    out["greedy"] = {"total_cost": float(g["total_cost"]),
                     "assignment": np.asarray(g["assignment"]).tolist()}
    victim = int(np.argmax(np.asarray(s["dispatch"]).sum(axis=0)))
    s2 = jr.on_pod_failure(victim, n_iters=ROUTER_ITERS)
    out["failover"] = dict(plan_record(s2, jr.history), pod=victim)
    feed_steady(jr, drift_rates(spec), seconds=DRIFT["seconds"],
                dt=DRIFT["dt"], a={DRIFT["new_class"]: DRIFT["new_a"]})
    res = jr.maybe_rebaseline(threshold=DRIFT["threshold"],
                              n_iters=DRIFT["n_iters"])
    s3 = jr.summary()
    out["rebaseline"] = {
        "drift": float(res["drift"]), "admissions": res["admissions"],
        "slot": int(jr._dynamic[DRIFT["new_class"]]),
        "cost": float(res["cost"]),
        "costs": [float(c) for c in jr._live.costs],
        "records": [r.kind for r in jr._live.records],
        "total_cost": float(s3["total_cost"])}
    out["seconds"] = time.time() - t0
    if ulp:
        return out
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("V", "S", "seconds")}))
    return out


def ulp_witness() -> None:
    """How far a one-ulp move of the link capacities moves the JAX
    router's own run at `router_256`, stage by stage, against the
    golden: the largest relative cost change of each stage."""
    with open(GOLDEN) as f:
        gold = json.load(f)
    moved = write_golden(ulp=True)

    def worst(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    print(json.dumps({
        "plan": worst(moved["plan"]["costs"], gold["plan"]["costs"]),
        "failover": worst(moved["failover"]["costs"],
                          gold["failover"]["costs"]),
        "rebaseline": worst(moved["rebaseline"]["costs"],
                            gold["rebaseline"]["costs"]),
        "rebaseline_by_step": [
            abs(x - y) / abs(y) for x, y in zip(
                moved["rebaseline"]["costs"], gold["rebaseline"]["costs"])]}))


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
    elif "--ulp-witness" in sys.argv[1:]:
        ulp_witness()
