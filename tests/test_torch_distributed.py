"""The task-sharded driver and the node-sharded measurement on the port
(`repro_torch.core.distributed`) against the JAX package's
`repro.core.distributed`.

World of one, in process (gloo, `device="cpu"`), on abilene: the host
and fused drivers against a live `repro.core.run_distributed` on the
default one-device mesh (costs at rtol 2e-4 with the same rejections, φ
at atol 1e-4) and bit for bit the port's own `run`; bucketed, dense,
faulted and guarded runs bit for bit the port's `run` of the same
options (each of which the single-process tests hold to the reference;
a live reference run costs 10-20 s of compiling a case), a chunked
faulted run bit for bit the whole one.  The halo plan of
`build_node_partition` equals the reference's table for table, and the
node-sharded measurement on a (1, 1) mesh equals `flows_carry_and_cost`
bit for bit.

ONE spawned 2-rank gloo job (`torch_dist_worker.py`) runs every
multi-rank check:
the task-sharded run on abilene cut to S = 9 (odd, so one padding task)
under the host and fused drivers and the dense engine, held to
`src/repro_torch/data/reference_distributed.json` (the reference's
2-device run) at rtol 2e-4 and φ at atol 1e-4, fused bit for bit host;
the node-sharded measurement at 2 node shards on fog against the
unsharded `flows_carry_and_cost` (traffic bit for bit, F / G / cost at
rtol 1e-6; the reference's own single-shard test fails under jax 0.9.0,
ROADMAP §3); and a faulted, guarded 2-rank run whose every rank reads
the same costs, trips and corruption count.  The file takes ~37 s
under `taskset -c 0` by pytest's clock, the spawned job (~10 s, most
of it its two ranks importing torch) and the live reference's one
compile (~10 s) included.

    PYTHONPATH=src python tests/test_torch_distributed.py --write-golden

writes the golden (the reference on a 2-device CPU mesh, in a
subprocess with `--xla_force_host_platform_device_count=2`).
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
GOLDEN = os.path.join(SRC, "repro_torch", "data",
                      "reference_distributed.json")
WORKER = os.path.join(HERE, "torch_dist_worker.py")
RTOL = 2e-4
PHI_ATOL = 1e-4
N_ITERS = 20
GOLD_ITERS = 20
NODE_RTOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks():
    """The one spawned 2-rank job; both ranks' results."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=SRC)
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(port), d], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
        return [json.load(open(os.path.join(d, f"rank{r}.json")))
                for r in range(2)]


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _check_run(got, want, label):
    assert got["n_rejected"] == want["n_rejected"], label
    assert len(got["costs"]) == len(want["costs"]), label
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=RTOL,
                               err_msg=label)
    for f, arr in want["phi"].items():
        np.testing.assert_allclose(np.asarray(got["phi"][f]),
                                   np.asarray(arr), atol=PHI_ATOL,
                                   err_msg=f"{label} {f}")


@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_two_ranks_match_reference_golden(two_ranks, method):
    """Two gloo ranks, S = 9 padded to 10, host driver: the reference's
    2-device run; both ranks read the same costs and the gathered φ."""
    gold = _golden()
    for r, out in enumerate(two_ranks):
        assert out["mesh"] == [r, 2]
        _check_run(out[method], gold[method], f"{method} rank {r}")
    assert two_ranks[0][method] == two_ranks[1][method]


def test_two_ranks_fused_and_guards(two_ranks):
    """The padded whole iterate gathered over two ranks (S = 9 -> 10, the
    padding task all-local and massless); the fused driver (CPU: eager,
    the same iteration) bit for bit the host driver over two ranks; the
    faulted, guarded run alike on both ranks, its trips rolled back and
    its costs finite."""
    a, b = two_ranks
    assert a["padded"] == b["padded"] == {
        "S": 9, "shape": [10, 11, a["padded"]["shape"][2]],
        "pad_local": [[1.0]] * 11, "pad_mass": 0.0}
    assert a["fused_equals_host"] and b["fused_equals_host"]
    assert a["guarded"] == b["guarded"]
    assert a["guarded"]["n_corrupt"] > 0
    assert np.isfinite(a["guarded"]["costs"]).all()
    assert all(act == "rollback" for _, _, act in a["guarded"]["trips"])


def test_two_node_shards_match_unsharded(two_ranks):
    """fog at (tasks, nodes) = (1, 2): the halo recursion's traffic bit
    for bit the unsharded solve, F / G / cost at rtol 1e-6."""
    for out in two_ranks:
        node = out["node"]
        assert node["shape"] == {"tasks": 1, "nodes": 2}
        assert node["traffic_bitwise"]
        assert node["F_rel"] <= NODE_RTOL and node["G_rel"] <= NODE_RTOL
        np.testing.assert_allclose(node["cost"], node["ref_cost"],
                                   rtol=NODE_RTOL)


# ------------------------------------------------- world of one, in process
import dataclasses

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro.core import distributed as jdist
from repro_torch import core as tcore
from repro_torch.core import distributed as tdist
from repro_torch.core import faults as tfaults
from repro_torch.core.guards import GuardConfig

torch.set_num_threads(1)


def _nets():
    from test_torch_sgp import jax_net
    tnet = tcore.make_scenario(tcore.TABLE_II["abilene"], device="cpu")
    return tnet, jax_net(tnet)


def _jphi(phi):
    return jcore.PhiSparse(*(jnp.asarray(getattr(phi, f).numpy())
                             for f in ("data", "local", "result")))


def _same(a, b, ha, hb):
    assert ha["costs"] == hb["costs"]
    assert ha["n_rejected"] == hb["n_rejected"]
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _near(phi, jphi, h, jh, label):
    assert h["n_rejected"] == jh["n_rejected"], label
    np.testing.assert_allclose(h["costs"], jh["costs"], rtol=RTOL,
                               err_msg=label)
    for f in dataclasses.fields(phi):
        np.testing.assert_allclose(getattr(phi, f.name).numpy(),
                                   np.asarray(getattr(jphi, f.name)),
                                   atol=PHI_ATOL, err_msg=label)


def test_world_of_one_matches_reference_and_run():
    """A world of one on the sparse engine: the host and fused drivers
    against the reference's `run_distributed` on its one-device mesh,
    and bit for bit the port's `run`."""
    tnet, jnet = _nets()
    phi0 = tcore.spt_phi_sparse(tnet)
    kw = dict(n_iters=N_ITERS, method="sparse")
    jp, jh = jdist.run_distributed(jnet, _jphi(phi0), driver="host", **kw)
    for drv in ("host", "fused"):
        p, h = tcore.run_distributed(tnet, phi0, driver=drv, **kw)
        _near(p, jp, h, jh, drv)
        pr, hr = tcore.run(tnet, phi0, driver=drv, **kw)
        _same(p, pr, h, hr)


@pytest.mark.parametrize("case", ["bucketed", "dense", "guarded"])
def test_world_of_one_is_run(case):
    """Bucketed, dense and guarded (fault-free) runs at a world of one:
    the host driver bit for bit the fused one and the port's fused `run`
    of the same options (each held to the reference by the
    single-process tests, `run`'s drivers to each other by
    `test_torch_fused.py`); the bucketed run bit for bit the padded one
    and the guarded run the unguarded one."""
    tnet, _ = _nets()
    dense = case == "dense"
    phi0 = tcore.spt_phi(tnet) if dense else tcore.spt_phi_sparse(tnet)
    kw = dict(n_iters=N_ITERS, method="dense" if dense else "sparse")
    extra = {"bucketed": {"bucketed": True}, "dense": {},
             "guarded": {"guards": GuardConfig()}}[case]
    p, h = tcore.run_distributed(tnet, phi0, driver="fused", **kw, **extra)
    pr, hr = tcore.run(tnet, phi0, driver="fused", **kw, **extra)
    _same(p, pr, h, hr)
    ph, hh = tcore.run_distributed(tnet, phi0, driver="host", **kw, **extra)
    _same(p, ph, h, hh)
    if extra:
        base, hb = tcore.run_distributed(tnet, phi0, **kw)
        _same(p, base, h, hb)
    if case == "guarded":
        assert h["guard_events"] == hh["guard_events"] == []


def test_world_of_one_faulted_and_guarded():
    """A faulted (participation 0.5, staleness 2, dropout 0.2, 30 %
    corruption) and guarded run bit for bit the port's `run` of the same
    plan and generator (which `test_torch_faults.py` holds to the
    reference on its own draws); a faulted run in four chunks bit for
    bit the whole one (its fault generator too)."""
    tnet, _ = _nets()
    phi0 = tcore.spt_phi_sparse(tnet)
    plan = tfaults.FaultPlan(participation_p=0.5, staleness_k=2,
                             dropout_p=0.2)

    def gen():
        return torch.Generator().manual_seed(5)
    bad = tfaults.FaultPlan(participation_p=0.5, staleness_k=2,
                            dropout_p=0.2, corrupt_p=0.3)
    guards = GuardConfig(checkpoint_every=2, max_retries=64)
    kw = dict(n_iters=N_ITERS, method="sparse", fault_plan=bad,
              guards=guards)
    p, h = tcore.run_distributed(tnet, phi0, fault_rng=gen(), **kw)
    pr, hr = tcore.run(tnet, phi0, fault_rng=gen(), **kw)
    _same(p, pr, h, hr)
    assert h["n_corrupt"] == hr["n_corrupt"] > 0
    assert [(e.it, e.sentinel) for e in h["guard_events"]] == \
        [(e.it, e.sentinel) for e in hr["guard_events"]]
    whole = tdist.init_distributed_state(tnet, phi0, method="sparse",
                                         fault_plan=plan, fault_rng=gen())
    tdist.run_distributed_chunk(whole, N_ITERS)
    parts = tdist.init_distributed_state(tnet, phi0, method="sparse",
                                         fault_plan=plan, fault_rng=gen())
    for _ in range(4):
        tdist.run_distributed_chunk(parts, N_ITERS // 4)
    assert whole.costs == parts.costs and whole.it == parts.it
    assert torch.equal(whole.fault_state.gen.get_state(),
                       parts.fault_state.gen.get_state())
    for f in ("data", "local", "result"):
        assert torch.equal(getattr(whole.phi, f), getattr(parts.phi, f))


def test_rebaseline_is_a_fresh_init():
    """`rebaseline_distributed_state` with a rate change is the fresh
    `init_distributed_state` of the new network and iterate (flows,
    constants, T⁰, σ and the counts), keeps the iteration count, and
    runs on bit for bit alike."""
    tnet, _ = _nets()
    phi0 = tcore.spt_phi_sparse(tnet)
    st = tdist.init_distributed_state(tnet, phi0, method="sparse")
    tdist.run_distributed_chunk(st, 5)
    net2 = dataclasses.replace(tnet, r=tnet.r * 1.1)
    phi = tdist.unpad_phi(st)
    tdist.rebaseline_distributed_state(st, net2, phi)
    fresh = tdist.init_distributed_state(net2, phi, method="sparse")
    assert st.it == 5 and st.costs == fresh.costs and st.sigma == 1.0
    for f in ("phi", "flows", "consts"):
        a, b = getattr(st, f), getattr(fresh, f)
        for g in dataclasses.fields(a):
            assert torch.equal(getattr(a, g.name), getattr(b, g.name)), g
    for s in (st, fresh):
        tdist.run_distributed_chunk(s, 5)
    assert st.costs == fresh.costs and st.it == 10


def test_standalone_steps_are_the_single_process_steps():
    """`make_distributed_step_flows` and `make_distributed_step` at a
    world of one: one step bit for bit `_sgp_step_flows_impl` and the
    public `sgp_step` (κ = 0) from φ⁰, the faulted step's too."""
    from repro_torch.core.sgp import _sgp_step_flows_impl, make_consts
    tnet, _ = _nets()
    nbrs = tcore.build_neighbors(tnet.adj)
    phi0 = tcore.spt_phi_sparse(tnet, nbrs)
    fl, T0 = tcore.flows_carry_and_cost(tnet, phi0, "sparse", nbrs=nbrs)
    consts = make_consts(tnet, T0)
    mesh = tdist.task_mesh(device="cpu")
    got = tdist.make_distributed_step_flows(
        mesh, method="sparse", nbrs=nbrs)(tnet, phi0, fl, consts, 1.0)
    want = _sgp_step_flows_impl(tnet, phi0, fl, consts, method="sparse",
                                nbrs=nbrs, sigma=1.0)
    assert torch.equal(got[2], want[2])
    for f in ("data", "local", "result"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f))
    plan = tfaults.FaultPlan(participation_p=0.5, corrupt_p=1.0)
    fs = tfaults.init_fault_state(tnet, phi0, fl, plan)
    gphi, _, _, gfs = tdist.make_distributed_step_flows(
        mesh, method="sparse", nbrs=nbrs, fault_plan=plan)(
            tnet, phi0, fl, consts, 1.0, fs)
    assert int(gfs.n_corrupt) == 1 and not bool(
        torch.isfinite(gphi.data).all())
    phi1, cost = tdist.make_distributed_step(mesh, method="sparse",
                                             nbrs=nbrs)(tnet, phi0, consts,
                                                        1.0)
    phi2, aux = tcore.sgp_step(tnet, phi0, consts, method="sparse",
                               nbrs=nbrs, kappa=0.0)
    assert torch.equal(cost, aux["cost"])
    for f in ("data", "local", "result"):
        assert torch.equal(getattr(phi1, f), getattr(phi2, f))


def test_pad_tasks_matches_reference():
    """Both φ layouts padded to a multiple of 4 shards exactly as the
    reference pads them (S = 10 -> 12)."""
    tnet, jnet = _nets()
    for phi in (tcore.spt_phi(tnet), tcore.spt_phi_sparse(tnet)):
        if isinstance(phi, tcore.PhiSparse):
            jphi = _jphi(phi)
        else:
            jphi = jcore.Phi(jnp.asarray(phi.data.numpy()),
                             jnp.asarray(phi.result.numpy()))
        tn, tp, S = tdist.pad_tasks(tnet, phi, 4)
        jn, jp, jS = jdist.pad_tasks(jnet, jphi, 4)
        assert S == jS == 10 and tn.S == 12
        for f in ("dest", "r", "a", "w", "task_type"):
            np.testing.assert_array_equal(getattr(tn, f).numpy(),
                                          np.asarray(getattr(jn, f)))
        for f in dataclasses.fields(tp):
            np.testing.assert_array_equal(getattr(tp, f.name).numpy(),
                                          np.asarray(getattr(jp, f.name)))


@pytest.mark.parametrize("name,n", [("fog", 2), ("fog", 4),
                                    ("abilene", 3)])
def test_node_partition_matches_reference(name, n):
    """`build_node_partition`'s halo plan, table for table."""
    tnet = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
    from test_torch_sgp import jax_net
    tp = tdist.build_node_partition(tcore.build_neighbors(tnet.adj), n)
    jp = jdist.build_node_partition(
        jcore.build_neighbors(jax_net(tnet).adj), n)
    for f in ("n", "V", "Vp", "Bmax", "Vl"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("bnd", "in_remap", "in_slot", "in_mask", "out_remap",
              "out_mask"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)


def test_node_sharded_single_shard_is_unsharded():
    """A (1, 1) mesh: the node-sharded measurement is
    `flows_carry_and_cost` bit for bit (the world of one's groups)."""
    tnet = tcore.make_scenario(tcore.TABLE_II["fog"], device="cpu")
    nbrs = tcore.build_neighbors(tnet.adj)
    phi = tcore.spt_phi_sparse(tnet, nbrs)
    ref, ref_cost = tcore.flows_carry_and_cost(tnet, phi, "sparse",
                                               nbrs=nbrs)
    carry, cost = tdist.node_flows_carry_and_cost(
        tnet, phi, nbrs, tdist.task_node_mesh(1, 1, device="cpu"))
    for f in ("t_data", "t_result", "F", "G"):
        assert torch.equal(getattr(carry, f), getattr(ref, f)), f
    assert torch.equal(cost, ref_cost)


# ---------------------------------------------------------------- golden
def _golden_child() -> None:
    """In a process whose jax sees two CPU devices: the reference's
    `run_distributed` on a 2-device task mesh, abilene at S = 9."""
    from test_torch_sgp import jax_net
    from torch_dist_worker import odd_abilene
    assert len(jax.devices()) == 2, jax.devices()
    tnet = odd_abilene(tcore)
    jnet = jax_net(tnet)
    mesh = jdist.task_mesh(2)
    out = {"command": "PYTHONPATH=src python tests/"
                      "test_torch_distributed.py --write-golden",
           "scenario": "abilene, last task dropped (S = 9)", "devices": 2,
           "n_iters": GOLD_ITERS, "driver": "host"}
    sp = tcore.spt_phi_sparse(tnet)
    jsp = jcore.PhiSparse(*(jnp.asarray(getattr(sp, f).numpy())
                            for f in ("data", "local", "result")))
    dn = tcore.spt_phi(tnet)
    jdn = jcore.Phi(jnp.asarray(dn.data.numpy()),
                    jnp.asarray(dn.result.numpy()))
    for method, phi0 in (("sparse", jsp), ("dense", jdn)):
        phi, h = jdist.run_distributed(jnet, phi0, n_iters=GOLD_ITERS,
                                       mesh=mesh, method=method,
                                       driver="host")
        out[method] = {"costs": [float(c) for c in h["costs"]],
                       "n_rejected": int(h["n_rejected"]),
                       "phi": {f: np.asarray(getattr(phi, f)).tolist()
                               for f in ("data", "local", "result")
                               if hasattr(phi, f)}}
    with open(GOLDEN, "w") as f:
        json.dump(out, f)
    print(json.dumps({m: out[m]["costs"][-1] for m in ("sparse", "dense")}))


if __name__ == "__main__":
    if "--golden-child" in sys.argv:
        _golden_child()
    elif "--write-golden" in sys.argv:
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                              + " --xla_force_host_platform_device_count=2"))
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--golden-child"], env=env, check=True)
