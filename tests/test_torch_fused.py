"""The port's fused driver against its host driver, bit for bit.

`driver="fused"` decides accept, σ and the tol exit on the device and
reads the chunk's costs back once; `driver="host"` reads each
candidate's cost and decides on the host.  Both run the same step, and
the fused select mirrors `accept_step`'s float32 operations, so the
costs list, `n_rejected`, the generator's draws and the final φ must be
equal exactly (`torch.equal`).  The cases mirror the JAX package's
tests/test_fused_driver.py: the small Table II rows (lhc, geant and
connected_er reject steps), paper scaling with its consts refresh, the
tol exit, the σ blow-up stop, Theorem-2 masks from one generator seed,
chunked runs, a dense φ in and out, the other options, callbacks and
the error cases.  On the CPU the fused iteration runs eagerly; on the
card it is one captured CUDA graph (chip_smoke.py holds that run to the
host driver in the same way).
"""
import dataclasses

import pytest
import torch

from repro_torch import core
from repro_torch.core import sgp
from repro_torch.kernels import ops

torch.set_num_threads(1)

SMALL = ["connected_er", "fog", "abilene", "lhc", "geant"]
_CACHE = {}


def _setup(name):
    if name not in _CACHE:
        net = core.make_scenario(core.TABLE_II[name], device="cpu")
        _CACHE[name] = (net, core.spt_phi_sparse(net))
    return _CACHE[name]


def _phi_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(sgp._fields(a),
                                                 sgp._fields(b)))


def _both(name, n_iters=25, phi0=None, **kw):
    net, sp0 = _setup(name)
    phi0 = sp0 if phi0 is None else phi0
    out = {}
    for driver in ("host", "fused"):
        opts = dict(kw)
        if "seed" in opts:
            opts["rng"] = torch.Generator().manual_seed(opts.pop("seed"))
        out[driver] = core.run(net, phi0, n_iters=n_iters, driver=driver,
                               method="sparse", **opts)
    (ph, hh), (pf, hf) = out["host"], out["fused"]
    assert hh["costs"] == hf["costs"], name
    assert hh["n_rejected"] == hf["n_rejected"], name
    assert _phi_equal(ph, pf), name
    return ph, hh


@pytest.mark.parametrize("name", SMALL)
def test_fused_bitwise_table_ii(name):
    _, hist = _both(name)
    if name in ("lhc", "geant", "connected_er"):
        assert hist["n_rejected"] > 0      # the reject branch ran


@pytest.mark.parametrize("opts", [
    dict(scaling="paper", refresh_every=5),
    dict(variant="gp", beta=0.5),
    dict(kappa=0.5),
    dict(use_blocking=False, bucketed=True),
], ids=["paper_refresh", "gp", "kappa", "no_blocking_bucketed"])
def test_fused_bitwise_options(opts):
    _both("lhc", n_iters=12, **opts)


def test_fused_bitwise_allowed_masks():
    net, _ = _setup("abilene")
    hop = core.spt_phi(net).result > 0
    allowed_d = torch.cat([hop, torch.ones(hop.shape[:2] + (1,),
                                           dtype=torch.bool)], dim=-1)
    _both("abilene", n_iters=12, allowed_data=allowed_d,
          allowed_result=hop, use_blocking=False)


def test_fused_bitwise_tol_exit():
    _, hist = _both("abilene", n_iters=40, tol=1e-3)
    assert len(hist["costs"]) < 41        # the exit fired


def test_fused_bitwise_async_generator():
    """Theorem-2 masks from one generator seed: the same draws in both
    drivers, and the generators end in the same state."""
    net, phi0 = _setup("fog")
    states = {}
    for driver in ("host", "fused"):
        gen = torch.Generator().manual_seed(7)
        st = core.init_run_state(net, phi0, rng=gen, method="sparse")
        core.run_chunk(net, st, 15, async_frac=0.3, driver=driver)
        states[driver] = (st, gen.get_state())
    (sh, gh), (sf, gf) = states["host"], states["fused"]
    assert sh.costs == sf.costs and sh.n_rejected == sf.n_rejected
    assert _phi_equal(sh.phi, sf.phi) and torch.equal(gh, gf)
    _, plain = core.run(net, phi0, n_iters=15, method="sparse")
    assert sh.costs != plain["costs"]     # the masks held rows back


def _nan_state(net, **kw):
    """Every candidate cost is NaN: each iteration is rejected, σ
    quadruples, and after 20 rejections (4^20 > 1e12) the run stops."""
    st = core.init_run_state(net, core.spt_phi_sparse(net), method="sparse",
                             **kw)
    bad = st.phi.data.clone()
    bad[..., 0] = float("nan")
    st.phi = dataclasses.replace(st.phi, data=bad)
    st.flows = None                   # solved again at the chunk's entry
    return st


def test_sigma_blowup_stop():
    net, _ = _setup("abilene")
    done = {}
    for driver in ("host", "fused"):
        gen = torch.Generator().manual_seed(3)
        st = core.run_chunk(net, _nan_state(net, rng=gen), 40,
                            async_frac=0.2, driver=driver)
        assert st.stopped and st.n_rejected == 20 and st.it == 20
        assert len(st.costs) == 1         # nothing was ever accepted
        done[driver] = (st, gen.get_state())
    (sh, gh), (sf, gf) = done["host"], done["fused"]
    assert sh.sigma == sf.sigma
    # the fused carry's frozen iterations drew masks; the generator is
    # rewound to where the host loop stopped drawing
    assert torch.equal(gh, gf)
    assert torch.equal(sh.phi.data.isnan(), sf.phi.data.isnan())
    again = core.run_chunk(net, sf, 5)    # a stopped state is a no-op
    assert again.it == 20 and again.n_rejected == 20


@pytest.mark.parametrize("driver", ["host", "fused"])
def test_chunks_resume_bitwise(driver):
    """Chunks of either driver walk the uninterrupted run exactly, the
    paper-scaling refresh cadence included (it reads the global it)."""
    net, phi0 = _setup("lhc")
    kw = dict(scaling="paper", refresh_every=4)
    phi, hist = core.run(net, phi0, n_iters=11, driver="host",
                         method="sparse", **kw)
    st = core.init_run_state(net, phi0, method="sparse")
    for n in (3, 5, 3):
        core.run_chunk(net, st, n, driver=driver, **kw)
    assert st.costs == hist["costs"] and st.it == 11
    assert st.n_rejected == hist["n_rejected"]
    assert _phi_equal(st.phi, phi)


def test_stream_advances_in_parts():
    net, phi0 = _setup("geant")
    _, hist = core.run(net, phi0, n_iters=9, driver="host", method="sparse")
    st = core.init_run_state(net, phi0, method="sparse")
    stream = sgp.FusedStream(net, st)
    stream.advance(4).advance(5)
    assert stream.finish() == []          # no rebaseline: one segment, in st
    assert st.costs == hist["costs"] and st.n_rejected == hist["n_rejected"]
    with pytest.raises(RuntimeError):
        stream.advance(1)


def test_dense_phi_in_dense_phi_out():
    net, sp0 = _setup("lhc")
    dense0 = core.spt_phi(net)
    ph, hh = _both("lhc", n_iters=10, phi0=dense0)
    assert isinstance(ph, core.Phi)
    sp, hs = core.run(net, sp0, n_iters=10, method="sparse")
    assert hh["costs"] == hs["costs"]
    dense = core.sparse_to_phi(sp, core.build_neighbors(net.adj), net.V)
    assert torch.equal(ph.data, dense.data)
    assert torch.equal(ph.result, dense.result)


def test_callback_picks_host():
    net, phi0 = _setup("lhc")
    seen = []

    def cb(it, phi, aux, accepted):
        assert set(aux) == {"cost", "flows", "marginals"}
        seen.append((it, accepted, float(aux["cost"])))

    _, hist = core.run(net, phi0, n_iters=8, callback=cb, method="sparse")
    _, host = core.run(net, phi0, n_iters=8, driver="host", method="sparse")
    assert hist["costs"] == host["costs"]
    assert [s[0] for s in seen] == list(range(8))
    assert sum(not acc for _, acc, _ in seen) == hist["n_rejected"]
    # aux describes the iterate the step started from
    assert seen[0][2] == pytest.approx(hist["costs"][0], rel=1e-7)


def test_errors():
    net, phi0 = _setup("abilene")
    st = core.init_run_state(net, phi0, method="sparse")
    with pytest.raises(ValueError, match="driver"):
        core.run_chunk(net, st, 2, driver="gpu")
    with pytest.raises(ValueError, match="callback"):
        core.run_chunk(net, st, 2, driver="fused",
                       callback=lambda *a: None)
    with pytest.raises(ValueError, match="generator"):
        core.run_chunk(net, st, 2, async_frac=0.5)
    with pytest.raises(ValueError, match="variant"):
        core.run_chunk(net, st, 2, variant="newton")
    with pytest.raises(ValueError, match="scaling"):
        core.run_chunk(net, st, 2, scaling="exact")
    with pytest.raises(ValueError, match="sparse"):
        core.init_run_state(net, phi0, method="dense")
    assert st.it == 0 and len(st.costs) == 1


def test_run_opts():
    keys = core.run_opt_keys()
    assert "driver" in keys and "kappa" in keys and "state" not in keys
    assert core.validate_run_opts({"tol": 1e-3}, keys, "x") == {"tol": 1e-3}
    with pytest.raises(ValueError, match="not supported"):
        core.validate_run_opts({"fault_plan": 1}, keys, "x")
    with pytest.raises(ValueError, match="set by"):
        core.validate_run_opts({"driver": "host"}, keys, "x",
                               reserved=("driver",))


def test_add_launches_counts_replays():
    """A graph's captured counts are added once a replay and taken back
    off the capture itself."""
    before = ops.launches()
    ops.add_launches({"edge_rounds": 5, "simplex_project": 2}, 3)
    ops.add_launches({"edge_rounds": 5, "simplex_project": 2}, -1)
    after = ops.launches()
    assert after["edge_rounds"] - before["edge_rounds"] == 10
    assert after["simplex_project"] - before["simplex_project"] == 4
    ops.add_launches({"edge_rounds": 5, "simplex_project": 2}, -2)
    assert ops.launches() == before
