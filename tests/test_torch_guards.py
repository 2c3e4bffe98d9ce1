"""Guards on the port (`repro_torch.core.guards`) against the JAX
package's `repro.core.guards`.

`_guarded_update_impl` is held to the reference's `_guarded_update` on
the same inputs (a carry and a two-slot checkpoint ring carried across
by `convert.guard_state_from_numpy`): a clean step, a rejected one, NaN
in φ, NaN in the cost, a drift in mass, a cost explosion, a poisoned
checkpoint and an exhausted retry budget.  The sentinel code, the
rollback flag, the restored cost, the carry and every `GuardState` field
are equal (the sanitized checkpoint to atol 1e-6, as
`sanitize_phi_sparse` itself).  A guarded corrupt run on abilene, its
draws fed from the reference, trips as `repro.core.run` did (the
iterations, sentinels and actions) with costs to rtol 2e-4, against
`src/repro_torch/data/reference_robust.json`, written by

    PYTHONPATH=src python tests/test_torch_guards.py --write-golden

(a live reference run compiles its guarded step, ~10 s on one core).
Where the run parts from the reference, the reference's cost and a
float64 cost on the port's own iterate accept the candidate that the
port's float32 cost rejects: the split is rounding.
Within the port: a guarded fault-free run is the unguarded one bit for
bit, the retry latch stops with a finite iterate, trips are numbered
across chunks, and a faulted, guarded `ReplayEngine` streams bit for bit
its event loop.
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
from repro.core import guards as jguards
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import faults as tfaults
from repro_torch.core import guards as tguards
from repro_torch.core import sgp
from test_torch_faults import (ReferenceDraws, assert_same, jplan, jtree,
                               nets, ref_draw_chain)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "data")
ROBUST = os.path.join(DATA, "reference_robust.json")
CFG = tguards.GuardConfig(checkpoint_every=2, max_retries=64)
GUARDED_PLAN = tfaults.FaultPlan(corrupt_p=0.5)
GUARDED_KEY, GUARDED_ITERS = 3, 30
# a candidate within this of the cost it must beat is decided by a few
# float32 ulps (test_guarded_corrupt_run_matches_reference)
TIE_RTOL = 1e-6
GS_FIELDS = ("ckpt_cost", "ckpt_sigma", "valid", "ptr", "window", "wptr",
             "retries", "n_trips")


def jcfg(cfg):
    return jguards.GuardConfig(**dataclasses.asdict(cfg))


def reference_guarded() -> dict:
    """The reference's guarded corrupt run on abilene from the port's φ⁰
    (`repro.core.run`'s fused driver, one `FusedStream` advanced an
    iteration at a time so each iteration's cost to beat, candidate
    cost, take and sentinel are kept) and the draws it made."""
    from repro.core import sgp as jsgp
    tnet, jnet, phi0 = nets("abilene")
    key = jax.random.PRNGKey(GUARDED_KEY)
    chain = ref_draw_chain(key, GUARDED_PLAN, tnet.V, n=GUARDED_ITERS)
    kw = dict(method="sparse", fault_plan=jplan(GUARDED_PLAN), fault_rng=key,
              guards=jcfg(CFG))
    st = jcore.init_run_state(jnet, jtree(jcore.PhiSparse, phi0), **kw)
    stream = jsgp.FusedStream(jnet, st)
    prev = []
    for _ in range(GUARDED_ITERS):
        prev.append(stream._prev)
        stream.advance(1)
    rows = jax.device_get((prev, stream._cost_h, stream._take_h,
                           stream._code_h))
    stream.finish()
    _, hist = jcore.run(jnet, jtree(jcore.PhiSparse, phi0),
                        n_iters=GUARDED_ITERS, **kw)
    assert hist["costs"] == st.costs
    return {"draws": [[np.asarray(x).tolist() for x in d] for d in chain],
            "iterations": [[float(p), float(c), bool(t), int(k)]
                           for p, c, t, k in zip(*rows)],
            "costs": [float(c) for c in hist["costs"]],
            "n_rejected": int(hist["n_rejected"]),
            "n_corrupt": int(hist["n_corrupt"]),
            "guard_events": [[e.it, e.sentinel, e.action, float(e.cost),
                              e.restored_cost]
                             for e in hist["guard_events"]]}


def write_golden(path=ROBUST):
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out["guarded_abilene"] = reference_guarded()
    out["guarded_abilene"]["source"] = (
        "repro.core.run(method='sparse', fault_plan=FaultPlan(corrupt_p="
        "0.5), fault_rng=PRNGKey(3), guards=GuardConfig(checkpoint_every=2"
        ", max_retries=64)), 30 iterations on abilene from the SPT φ⁰, "
        "on the CPU: PYTHONPATH=src python tests/test_torch_guards.py "
        "--write-golden")
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")


# ----------------------------------------------------- the guarded update
def _base():
    """A carry three iterations in on abilene, its next candidate, and a
    ring holding φ⁰ (σ 1) and the carry (σ 4) with slots 2-3 free."""
    tnet, jnet, phi0 = nets("abilene")
    nbrs = tcore.build_neighbors(tnet.adj)
    st = tcore.init_run_state(tnet, phi0, method="sparse", nbrs=nbrs)
    fl0, T0 = st.flows, st.costs[0]
    tcore.run_chunk(tnet, st, 3)
    phi, fl, T = st.phi, st.flows, st.costs[-1]
    nxt = tcore.init_run_state(tnet, phi, method="sparse", nbrs=nbrs)
    tcore.run_chunk(tnet, nxt, 1)
    assert len(nxt.costs) == 2             # the candidate was accepted
    R, W = CFG.ring, CFG.window

    def ring(a, b):
        x = np.zeros((R,) + tuple(a.shape), a.numpy().dtype)
        x[0], x[1] = a.numpy(), b.numpy()
        return x
    gs = dict(
        ckpt_phi=[ring(a, b) for a, b in zip(sgp._fields(phi0),
                                              sgp._fields(phi))],
        ckpt_fl=[ring(a, b) for a, b in zip(sgp._fields(fl0),
                                             sgp._fields(fl))],
        ckpt_cost=np.array([T0, T] + [np.inf] * (R - 2), np.float32),
        ckpt_sigma=np.array([1.0, 4.0] + [1.0] * (R - 2), np.float32),
        valid=np.array([True, True] + [False] * (R - 2)), ptr=2,
        window=np.array([T0, T] + [np.inf] * (W - 2), np.float32), wptr=2,
        retries=1, n_trips=1)
    carry = dict(phi=phi, fl=fl, sigma=2.0, prev=T, n_costs=4, n_rej=1,
                 stopped=False)
    cand = dict(phi_new=nxt.phi, fl_new=nxt.flows, cost_new=nxt.costs[-1])
    return nbrs, gs, carry, cand


def _poison(phi, **fields):
    return tcore.PhiSparse(*(fields.get(f, getattr(phi, f)) for f in
                             ("data", "local", "result")))


def _case(name, gs, carry, cand):
    """Inputs of one sentinel case (numpy ring fields, port tensors)."""
    T = carry["prev"]
    phi_new = cand["phi_new"]
    nan_phi = phi_new.data.clone()
    nan_phi[0, 0, 0] = float("nan")
    if name == "rejected":
        cand = dict(cand, cost_new=2.0 * T)
    elif name in ("nan_phi", "exhausted"):
        cand = dict(cand, phi_new=_poison(phi_new, data=nan_phi))
        if name == "exhausted":
            gs = dict(gs, retries=CFG.max_retries)
    elif name == "nan_cost":
        carry = dict(carry, prev=float("nan"))
        cand = dict(cand, phi_new=carry["phi"], fl_new=carry["fl"],
                    cost_new=float("nan"))
    elif name == "mass_drift":
        cand = dict(cand, phi_new=_poison(phi_new, local=phi_new.local * 2))
    elif name == "explosion":
        win = gs["window"].copy()
        win[0], win[1] = T / 100, np.inf
        gs = dict(gs, window=win)
    elif name == "poisoned_checkpoint":
        data = gs["ckpt_phi"][0].copy()
        data[1, 0, 0, 0] = np.nan               # the newest slot
        gs = dict(gs, ckpt_phi=[data] + gs["ckpt_phi"][1:])
        cand = dict(cand, phi_new=_poison(phi_new, data=nan_phi))
    return gs, carry, cand


CASES = {"clean": 0, "rejected": 0, "nan_phi": 2, "nan_cost": 1,
         "mass_drift": 3, "explosion": 4, "poisoned_checkpoint": 2,
         "exhausted": 2}


@pytest.mark.parametrize("name", list(CASES))
def test_guarded_update_matches_reference(name):
    nbrs, *base = _base()
    gs, carry, cand = _case(name, *base)
    f32 = np.float32
    # the reference's inputs (its guarded fused driver's dtypes)
    jgs = jguards.GuardState(
        ckpt_phi=jcore.PhiSparse(*map(jnp.asarray, gs["ckpt_phi"])),
        ckpt_fl=jcore.FlowsCarry(*map(jnp.asarray, gs["ckpt_fl"])),
        ckpt_cost=jnp.asarray(gs["ckpt_cost"]),
        ckpt_sigma=jnp.asarray(gs["ckpt_sigma"]),
        valid=jnp.asarray(gs["valid"]),
        ptr=jnp.asarray(gs["ptr"], jnp.int32),
        window=jnp.asarray(gs["window"]),
        wptr=jnp.asarray(gs["wptr"], jnp.int32),
        retries=jnp.asarray(gs["retries"], jnp.int32),
        n_trips=jnp.asarray(gs["n_trips"], jnp.int32))
    want = jguards._guarded_update(
        jtree(jcore.PhiSparse, cand["phi_new"]),
        jtree(jcore.FlowsCarry, cand["fl_new"]),
        jnp.float32(cand["cost_new"]), jtree(jcore.PhiSparse, carry["phi"]),
        jtree(jcore.FlowsCarry, carry["fl"]), jnp.float32(carry["sigma"]),
        jnp.float32(carry["prev"]), jnp.asarray(carry["n_costs"], jnp.int32),
        jnp.asarray(carry["n_rej"], jnp.int32),
        jnp.asarray(carry["stopped"]), None, None, jnp.float32(0.0), jgs,
        jcore.build_neighbors(nets("abilene")[1].adj), adaptive=True,
        cfg=jcfg(CFG), do_ckpt=True)
    tgs = convert.guard_state_from_numpy(device="cpu", **gs)
    phi = tcore.PhiSparse(*(t.clone() for t in sgp._fields(carry["phi"])))
    fl = tcore.FlowsCarry(*(t.clone() for t in sgp._fields(carry["fl"])))

    def t32(x):
        return torch.tensor(f32(x))
    got = tguards._guarded_update_impl(
        cand["phi_new"], cand["fl_new"], t32(cand["cost_new"]), phi, fl,
        t32(carry["sigma"]), t32(carry["prev"]),
        torch.tensor(carry["n_costs"], dtype=torch.int32),
        torch.tensor(carry["n_rej"], dtype=torch.int32),
        torch.tensor(carry["stopped"]), t32(0.0), tgs, nbrs, adaptive=True,
        cfg=CFG, do_ckpt=True)
    (sigma, prev, n_costs, n_rej, stopped, take, live, gs_out, code, rolled,
     ck_cost) = got
    (w_phi, w_fl, w_sigma, w_prev, w_n_costs, w_n_rej, w_stopped, _, w_take,
     w_live, w_gs, w_code, w_rolled, w_ck) = want
    assert int(code) == int(w_code) == CASES[name]
    assert bool(rolled) == bool(w_rolled) == (name not in
                                              ("clean", "rejected",
                                               "exhausted"))
    for a, b, label in ((sigma, w_sigma, "sigma"), (prev, w_prev, "prev"),
                        (n_costs, w_n_costs, "n_costs"),
                        (n_rej, w_n_rej, "n_rej"),
                        (stopped, w_stopped, "stopped"),
                        (take, w_take, "take"), (live, w_live, "live"),
                        (ck_cost, w_ck, "ckpt_cost")):
        assert_same(a, b, f"{name} {label}")
    # the sanitized checkpoint renormalises its rows in float32 sums of
    # another order (sanitize_phi_sparse's own parity is atol 1e-6)
    atol = 1e-6 if name == "poisoned_checkpoint" else 0.0
    for a, b in zip(sgp._fields(phi) + sgp._fields(fl),
                    jax.tree.leaves(w_phi) + jax.tree.leaves(w_fl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol, err_msg=name)
    for a, b in zip(sgp._fields(gs_out.ckpt_phi) + sgp._fields(
            gs_out.ckpt_fl), jax.tree.leaves(w_gs.ckpt_phi)
            + jax.tree.leaves(w_gs.ckpt_fl)):
        assert_same(a, b, f"{name} ring")
    for f in GS_FIELDS:
        assert_same(getattr(gs_out, f), getattr(w_gs, f), f"{name} {f}")


# ------------------------------------------------------------- trajectories
@pytest.mark.parametrize("name", ["connected_er", "fog", "abilene"])
def test_guarded_fault_free_bitwise(name):
    """No fault, no trip: every guard select passes the accepted carry
    through, so costs, rejections and φ are the unguarded run's."""
    tnet, _, phi0 = nets(name)
    pa, ha = tcore.run(tnet, phi0, n_iters=20, method="sparse")
    pb, hb = tcore.run(tnet, phi0, n_iters=20, method="sparse",
                       guards=tguards.GuardConfig())
    assert ha["costs"] == hb["costs"] and hb["guard_events"] == []
    assert ha["n_rejected"] == hb["n_rejected"]
    assert all(torch.equal(a, b) for a, b in zip(sgp._fields(pa),
                                                 sgp._fields(pb)))


def test_guarded_chunked_resume_bitwise():
    """The guard carry rides `RunState` and the checkpoint cadence follows
    the global iteration: 12 guarded iterations are 4 + 4 + 4."""
    tnet, _, phi0 = nets("fog")
    cfg = tguards.GuardConfig(checkpoint_every=3)
    pa, ha = tcore.run(tnet, phi0, n_iters=12, method="sparse", guards=cfg)
    st = tcore.init_run_state(tnet, phi0, method="sparse", guards=cfg)
    for _ in range(3):
        tcore.run_chunk(tnet, st, 4)
    assert ha["costs"] == st.costs
    assert all(torch.equal(a, b) for a, b in zip(sgp._fields(pa),
                                                 sgp._fields(st.phi)))


@pytest.fixture(scope="module")
def golden():
    with open(ROBUST) as f:
        return json.load(f)["guarded_abilene"]


def test_guarded_corrupt_run_matches_reference(golden, monkeypatch):
    """corrupt_p = 0.5 under guards (checkpoints every 2 iterations, 64
    retries), the reference's draws fed in: the reference's trips (it,
    sentinel, action), their candidate and restored costs and the
    accepted costs to rtol 2e-4, up to the first iteration whose
    candidate the reference decided by a near-tie (within TIE_RTOL of the
    cost to beat: a few float32 ulps, under the two packages' sum-order
    differences, ROADMAP.md §3).  After it the port's trips are
    rollbacks, its costs finite and its final cost the reference's to
    rtol 2e-4; every corruption fires as the reference's."""
    tnet, _, phi0 = nets("abilene")
    feed = ReferenceDraws(golden["draws"])
    monkeypatch.setattr(tfaults, "draw_faults", feed)
    phi, hist = tcore.run(tnet, phi0, n_iters=GUARDED_ITERS, method="sparse",
                          fault_plan=GUARDED_PLAN, guards=CFG)
    its = golden["iterations"]
    tie = next((t for t, (prev, cand, _, _) in enumerate(its)
                if abs(cand - prev) <= TIE_RTOL * prev), len(its))
    assert tie >= 20
    events = hist["guard_events"]
    held = [e for e in events if e.it < tie]
    want = [e for e in golden["guard_events"] if e[0] < tie]
    assert [(e.it, e.sentinel, e.action) for e in held] == \
        [tuple(e[:3]) for e in want]
    assert len(held) >= 10
    for e, w in zip(held, want):
        np.testing.assert_allclose(e.cost, w[3], rtol=2e-4)
        assert (e.restored_cost is None) == (w[4] is None)
        if w[4] is not None:
            np.testing.assert_allclose(e.restored_cost, w[4], rtol=2e-4)
    n_acc = 1 + sum(take for _, _, take, _ in its[:tie])
    np.testing.assert_allclose(hist["costs"][:n_acc],
                               golden["costs"][:n_acc], rtol=2e-4)
    assert all(e.action == "rollback" for e in events)
    assert hist["n_corrupt"] == golden["n_corrupt"] >= len(events)
    assert np.isfinite(hist["costs"]).all()
    np.testing.assert_allclose(hist["final_cost"], golden["costs"][-1],
                               rtol=2e-4)
    assert all(bool(torch.isfinite(t).all()) for t in sgp._fields(phi))


def test_guarded_corrupt_run_split_is_float32_rounding(golden, monkeypatch):
    """The witness for where the guarded corrupt run parts from the
    reference: at the first iteration the reference trips and the port
    does not, the port rejects a candidate that its float32 cost puts
    above the cost to beat.  On the port's own iterate and candidate the
    reference's cost (its sum order) accepts it, and so does a float64
    cost: the split is float32 rounding, and both side with the
    reference."""
    tnet, jnet, phi0 = nets("abilene")
    monkeypatch.setattr(tfaults, "draw_faults",
                        ReferenceDraws(golden["draws"]))
    st = tcore.init_run_state(tnet, phi0, method="sparse",
                              fault_plan=GUARDED_PLAN, guards=CFG)
    stream = sgp.FusedStream(tnet, st)
    ref_trips = {e[0] for e in golden["guard_events"]}

    def snap(x):
        return type(x)(*(t.clone() for t in sgp._fields(x)))
    for it in range(GUARDED_ITERS):
        carry = (snap(stream._phi), snap(stream._fl), snap(stream._consts),
                 stream._sigma.clone(), stream._prev.clone())
        stream.advance(1)
        cost, take, _, code = stream._hist[-1][0, :4].tolist()
        if (it in ref_trips) != (code > 0):
            break
    else:
        pytest.fail("the port trips as the reference throughout")
    stream.finish()
    phi, fl, consts, sigma, prev32 = carry
    assert it in ref_trips and not take      # the port rejected
    cand, _, c32 = sgp._sgp_step_flows_impl(
        tnet, phi, fl, consts, sigma=sigma, nbrs=st.nbrs, method="sparse")
    assert c32.item() == cost and c32 > prev32
    assert torch.equal(tcore.flows_carry_and_cost(
        tnet, phi, "sparse", nbrs=st.nbrs)[1], prev32)

    jnbrs = jcore.build_neighbors(jnet.adj)
    jcost = jax.jit(lambda p: jcore.flows_carry_and_cost(
        jnet, p, "sparse", nbrs=jnbrs)[1])
    assert jcost(jtree(jcore.PhiSparse, cand)) \
        <= jcost(jtree(jcore.PhiSparse, phi))

    def f64(x):
        return type(x)(*(t.double() if t.is_floating_point() else t
                         for t in sgp._fields(x)))
    net64 = dataclasses.replace(
        tnet, r=tnet.r.double(), a=tnet.a.double(), w=tnet.w.double(),
        **{c: dataclasses.replace(getattr(tnet, c),
                                  params=getattr(tnet, c).params.double())
           for c in ("link_cost", "comp_cost")})
    c64, prev64 = (tcore.flows_carry_and_cost(net64, f64(p), "sparse",
                                              nbrs=st.nbrs)[1]
                   for p in (cand, phi))
    assert c64.dtype == torch.float64 and c64 < prev64


def test_retry_latch_and_numbering():
    """corrupt_p = 1.0 trips every iteration: after `max_retries`
    rollbacks the guard latches a stop that still restores the
    checkpoint (a finite iterate); trips are numbered by the global
    iteration across chunks."""
    tnet, _, phi0 = nets("abilene")
    plan = tfaults.FaultPlan(corrupt_p=1.0)
    cfg = tguards.GuardConfig(checkpoint_every=2, max_retries=2)
    st = tcore.init_run_state(tnet, phi0, method="sparse", fault_plan=plan,
                              guards=cfg)
    tcore.run_chunk(tnet, st, 20)
    assert st.stopped
    assert [e.action for e in st.guard_events] == ["rollback"] * 2 + \
        ["stop"]
    assert all(bool(torch.isfinite(t).all()) for t in sgp._fields(st.phi))
    st = tcore.init_run_state(tnet, phi0, method="sparse", fault_plan=plan,
                              guards=dataclasses.replace(cfg,
                                                         max_retries=100))
    tcore.run_chunk(tnet, st, 4)
    tcore.run_chunk(tnet, st, 4)
    its = [e.it for e in st.guard_events]
    assert its == sorted(its) and max(its) >= 4


def test_replay_engine_faulted_and_guarded():
    """A faulted, guarded replay of abilene_churn: the fused stream is
    its event loop bit for bit (costs, records, final φ, the trips in
    `guard_log`), every segment drawing its own fault stream, and the
    live iterate stays finite."""
    tnet, _, phi0 = nets("abilene")
    sched = tcore.churn_schedule("abilene_churn", tnet)
    out = []
    for stream in (False, True):
        eng = tcore.ReplayEngine(
            tnet, phi0=phi0, invariant_checks=not stream,
            fault_plan=tfaults.FaultPlan(participation_p=0.5,
                                         corrupt_p=0.3),
            fault_rng=torch.Generator().manual_seed(5),
            guards=tguards.GuardConfig(checkpoint_every=2, max_retries=64))
        out.append((eng, eng.play(sched, tail_iters=5, stream=stream)))
    (e0, h0), (e1, h1) = out
    assert h0["costs"] == h1["costs"] and h0["n_iters"] == h1["n_iters"]
    assert [(r.it, r.kind, r.cost_before, r.cost_after, r.segment_costs)
            for r in h0["records"]] == \
        [(r.it, r.kind, r.cost_before, r.cost_after, r.segment_costs)
         for r in h1["records"]]
    assert h0["guard_events"] == h1["guard_events"] == e0.guard_log
    assert len(e0.guard_log) >= 1
    assert all(e.action in ("rollback", "stop") for e in e0.guard_log)
    assert all(torch.equal(a, b) for a, b in zip(sgp._fields(e0.phi),
                                                 sgp._fields(e1.phi)))
    assert all(bool(torch.isfinite(t).all()) for t in sgp._fields(e0.phi))


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
