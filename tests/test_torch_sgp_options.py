"""Algorithm 1's options on the port against the JAX package.

Step level, live (one small jitted reference each):

* the stacked longest-path recursion (`_max_path_len_pair_sparse`, K1 /
  K2's `max, shift=1` case) on padded tiles and on buckets, exactly;
  inside the port, stacked equals unstacked and bucketed equals padded
  bit for bit;
* `gp_rows` to atol 1e-6 (a handful of float32 operations a coordinate);
* one propose from the same iterate and flows under `variant="gp"`
  with `use_blocking=False` and SPOO's allowed masks, under `kappa=0.5`
  with the Theorem-2 row masks fed in from numpy on a dense `Phi`, and
  under `scaling="paper"`: the candidate to atol 1e-4 (the main path's
  φ tolerance);
* `uniform_phi`, `offload_phi` and `as_dense_phi`, exactly.

Run level, stored: the reference's 10-iteration host-driver runs of
`abilene` and `lhc` under each option set of RUN_OPTS: costs within
rtol 1e-4 with the same rejections, as `check_port_row` holds the main
path, and the final φ within atol 1e-4 on every row that carries at
least 1e-4 of traffic.  Lighter rows are held by their flow t·φ, to
atol 1e-6: the Eq. 15 scaling M ∝ t makes a row with t ~ 1e-7 take
steps of δ/t, so float32 rounding moves its φ by ~0.1.  Under paper
scaling `lhc` has six such data coordinates (t 1e-7 to 2e-6) where the
port and the reference part by up to 0.098; a one-ulp change of the
link parameters moves the reference's own φ there by 0.085, its costs
by 2.5e-7 (`--ulp-witness` below).  The reference's outputs live in
`src/repro_torch/data/reference_options.npz`, written by

    PYTHONPATH=src python tests/test_torch_sgp_options.py --write-references

(about half a minute on a CPU).  Runs with `async_frac` draw their masks from `jax.random`
there and from a torch.Generator here; they are held against the port's
own host driver in test_torch_fused.py.
"""
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import network as jnetwork
from repro.core import sgp as jsgp
from repro_torch import core as tcore
from repro_torch.convert import phi_sparse_to_numpy
from repro_torch.core import sgp as tsgp
from test_torch_sgp import BA_SMALL, DATA, jax_net

torch.set_num_threads(1)

REFS = os.path.join(DATA, "reference_options.npz")
N_ITERS = 10
RUN_ROWS = ["abilene", "lhc"]
# option set -> run options; "spoo" also takes SPOO's allowed masks
RUN_OPTS = {"paper": dict(scaling="paper", refresh_every=5),
            "gp": dict(variant="gp", beta=0.5),
            "kappa": dict(kappa=0.5),
            "spoo": dict(use_blocking=False)}
PHI_FIELDS = ("data", "local", "result")


def spoo_masks(net):
    """SPOO's permission masks (`repro.core.baselines.run_spoo`): data to
    the shortest-path next hop or local, results along the tree."""
    hop = tcore.spt_phi(net).result.cpu().numpy() > 0
    allowed_d = np.concatenate([hop, np.ones(hop.shape[:2] + (1,), bool)],
                               axis=-1)
    return allowed_d, hop


def run_opts(name, opt, net, to):
    opts = dict(RUN_OPTS[opt])
    if opt == "spoo":
        ad, ar = spoo_masks(net)
        opts.update(allowed_data=to(ad), allowed_result=to(ar))
    return opts


def reference_runs():
    """The JAX package's runs of every (row, option set), as numpy."""
    out = {}
    for name in RUN_ROWS:
        tnet = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
        jnet = jcore.make_scenario(jcore.TABLE_II[name])
        jphi0 = jcore.spt_phi_sparse(jnet)
        for opt in RUN_OPTS:
            jphi, hist = jcore.run(
                jnet, jphi0, n_iters=N_ITERS, method="sparse",
                driver="host", **run_opts(name, opt, tnet, jnp.asarray))
            key = f"{name}__{opt}__"
            out[key + "costs"] = np.asarray(hist["costs"], np.float64)
            out[key + "n_rejected"] = np.asarray(int(hist["n_rejected"]))
            for f in PHI_FIELDS:
                out[key + f"phi_{f}"] = np.asarray(getattr(jphi, f))
            print(name, opt, hist["costs"], hist["n_rejected"], flush=True)
    return out


@pytest.fixture(scope="module")
def stored():
    with np.load(REFS) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("opt", list(RUN_OPTS))
@pytest.mark.parametrize("name", RUN_ROWS)
def test_run_matches_reference(stored, name, opt):
    net = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
    phi, hist = tcore.run(net, tcore.spt_phi_sparse(net), n_iters=N_ITERS,
                          method="sparse",
                          **run_opts(name, opt, net, torch.as_tensor))
    key = f"{name}__{opt}__"
    want = stored[key + "costs"]
    assert len(hist["costs"]) == len(want)
    assert hist["n_rejected"] == int(stored[key + "n_rejected"])
    np.testing.assert_allclose(hist["costs"], want, rtol=1e-4)
    fl, _ = tcore.flows_carry_and_cost(net, phi, "sparse")
    t = {"data": fl.t_data, "local": fl.t_data, "result": fl.t_result}
    for f, got in zip(PHI_FIELDS, phi_sparse_to_numpy(phi)):
        ref = stored[key + f"phi_{f}"]
        tf = t[f].numpy()[..., None]
        heavy = np.broadcast_to(tf >= 1e-4, got.shape)
        np.testing.assert_allclose(got[heavy], ref[heavy], atol=1e-4,
                                   err_msg=f)
        np.testing.assert_allclose((tf * got)[~heavy], (tf * ref)[~heavy],
                                   atol=1e-6, err_msg=f"{f} flows")


# ------------------------------------------------------------ step level
def _dag_supports(net, nbrs, seed, n=2):
    """Random loop-free supports on the out-edge slots (edges to higher
    node ids), as the longest-path recursion sees on a loop-free φ."""
    rs = np.random.RandomState(seed)
    nbr = nbrs.out_nbr.numpy()
    ok = nbrs.out_mask.numpy() & (nbr > np.arange(net.V)[:, None])
    return [(rs.random_sample((net.S,) + nbr.shape) < 0.5) & ok
            for _ in range(n)]


@pytest.mark.parametrize("bucketed", [False, True], ids=["padded",
                                                          "bucketed"])
def test_max_path_len_pair_matches_reference(bucketed):
    net = tcore.make_scenario(BA_SMALL, device="cpu")
    nbrs = tcore.build_neighbors(net.adj)
    bk = tcore.build_buckets(net.adj) if bucketed else None
    sa, sb = _dag_supports(net, nbrs, seed=3)
    ta, tb = torch.as_tensor(sa), torch.as_tensor(sb)
    h_a, h_b = tsgp._max_path_len_pair_sparse(ta, tb, nbrs, buckets=bk)
    # inside the port: stacked = unstacked, bucketed = padded, bit for bit
    for h, s in ((h_a, ta), (h_b, tb)):
        assert torch.equal(h, tsgp._max_path_len_sparse(s, nbrs,
                                                        buckets=bk))
        assert torch.equal(h, tsgp._max_path_len_sparse(s, nbrs))
    assert float(h_a.max()) >= 3          # real paths, not just zeros
    adj = net.adj.numpy()
    jnb = jcore.build_neighbors(adj)
    jbk = jnetwork.build_buckets(adj) if bucketed else None
    fn = jax.jit(partial(jsgp._max_path_len_pair_sparse, nbrs=jnb,
                         buckets=jbk))
    j_a, j_b = fn(jnp.asarray(sa), jnp.asarray(sb))
    np.testing.assert_array_equal(h_a.numpy(), np.asarray(j_a))
    np.testing.assert_array_equal(h_b.numpy(), np.asarray(j_b))


def test_gp_rows_matches_reference():
    rs = np.random.RandomState(5)
    R, K = 64, 9
    phi = rs.random_sample((R, K)).astype(np.float32)
    phi /= phi.sum(-1, keepdims=True)
    delta = (rs.random_sample((R, K)) * 3).astype(np.float32)
    t = (rs.random_sample(R) * 2).astype(np.float32)
    t[::7] = 0.0
    perm = rs.random_sample((R, K)) < 0.7
    perm[::11] = False
    got = tsgp.gp_rows(*map(torch.as_tensor, (phi, delta, t, perm)), 0.5)
    want = jax.jit(jsgp.gp_rows, static_argnums=4)(
        *map(jnp.asarray, (phi, delta, t, perm)), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def propose_inputs():
    """lhc after three port iterations (data support off the local
    column), its flows, and both packages' versions of them."""
    name = "lhc"
    tnet = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
    nbrs = tcore.build_neighbors(tnet.adj)
    tphi, _ = tcore.run(tnet, tcore.spt_phi_sparse(tnet), n_iters=3,
                        driver="host", method="sparse")
    arrays = phi_sparse_to_numpy(tphi)
    jnet = jax_net(tnet)
    jnb = jcore.build_neighbors(tnet.adj.numpy())
    jphi = jnetwork.PhiSparse(*map(jnp.asarray, arrays))
    rs = np.random.RandomState(11)
    masks = [rs.random_sample((tnet.S, tnet.V)) < 0.6 for _ in range(2)]
    return dict(tnet=tnet, nbrs=nbrs, tphi=tphi, jnet=jnet, jnb=jnb,
                jphi=jphi, masks=masks, spoo=spoo_masks(tnet))


# case -> (options, SPOO's allowed masks, Theorem-2 masks on a dense φ);
# κ is given in every case: the two packages' propose defaults differ
PROPOSE_CASES = {
    "gp_spoo": (dict(variant="gp", beta=0.5, use_blocking=False,
                     kappa=0.0), True, False),
    "kappa_masks_dense": (dict(kappa=0.5, sigma=2.0), False, True),
    "paper": (dict(scaling="paper", kappa=1.0), False, False),
}


@pytest.mark.parametrize("case", list(PROPOSE_CASES))
def test_propose_matches_reference(propose_inputs, case):
    p = propose_inputs
    tnet, nbrs, jnet, jnb = p["tnet"], p["nbrs"], p["jnet"], p["jnb"]
    opts, spoo, masks = PROPOSE_CASES[case]
    opts = dict(opts)
    tphi, jphi = p["tphi"], p["jphi"]
    t_kw, j_kw = {}, {}
    if spoo:
        ad, ar = p["spoo"]
        t_kw = dict(allowed_data=torch.as_tensor(ad),
                    allowed_result=torch.as_tensor(ar))
        j_kw = dict(allowed_data=jnp.asarray(ad),
                    allowed_result=jnp.asarray(ar))
    if masks:
        md, mr = p["masks"]
        t_kw = dict(mask_data=torch.as_tensor(md),
                    mask_result=torch.as_tensor(mr))
        j_kw = dict(mask_data=jnp.asarray(md), mask_result=jnp.asarray(mr))
        tphi = tcore.sparse_to_phi(tphi, nbrs, tnet.V)
        jphi = jnetwork.sparse_to_phi(jphi, jnb, tnet.V)
    tfl, T = tcore.flows_carry_and_cost(tnet, tphi, "sparse", nbrs=nbrs)
    tconsts = tcore.make_consts(tnet, T)
    jfl, jT = jnetwork.flows_carry_and_cost(jnet, jphi, "sparse", nbrs=jnb)
    jconsts = jsgp.make_consts(jnet, jT)
    got, _ = tsgp._sgp_propose_impl(tnet, tphi, tfl, tconsts, nbrs=nbrs,
                                    method="sparse", **opts, **t_kw)
    sigma = opts.pop("sigma", 1.0)
    fn = jax.jit(partial(jsgp._sgp_propose_impl, method="sparse",
                         slot_F=True, nbrs=jnb, **opts))
    want, _ = fn(jnet, jphi, jfl, jconsts, sigma=jnp.float32(sigma), **j_kw)
    assert type(got).__name__ == type(want).__name__
    for f in ("data", "result") if masks else PHI_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   err_msg=f)
    if masks:
        # rows the masks hold keep the iterate exactly
        keep = ~p["masks"][1]
        np.testing.assert_array_equal(got.result.numpy()[keep],
                                      tphi.result.numpy()[keep])


def test_initial_phis_match_reference():
    tnet = tcore.make_scenario(tcore.TABLE_II["abilene"], device="cpu")
    jnet = jax_net(tnet)
    pairs = [(tcore.uniform_phi(tnet), jnetwork.uniform_phi(jnet)),
             (tcore.offload_phi(tnet, [0, 3, 7]),
              jnetwork.offload_phi(jnet, [0, 3, 7]))]
    nbrs = tcore.build_neighbors(tnet.adj)
    sp = tcore.spt_phi_sparse(tnet, nbrs)
    pairs.append((tcore.as_dense_phi(sp, tnet),
                  jnetwork.as_dense_phi(jcore.spt_phi_sparse(jnet), jnet)))
    dense = pairs[0][0]
    assert tcore.as_dense_phi(dense, tnet) is dense
    for got, want in pairs:
        for f in ("data", "result"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


def ulp_witness(name="lhc", opt="paper"):
    """How far the reference's own run moves when its link parameters
    move by one ulp: prints the largest φ change per field, the count
    above 1e-4, and the costs' largest relative change."""
    import dataclasses
    from repro.core.costs import Cost as JCost
    tnet = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
    jnet = jcore.make_scenario(jcore.TABLE_II[name])
    p = np.asarray(jnet.link_cost.params)
    up = np.nextafter(p, np.float32(np.inf)).astype(np.float32)
    jnet2 = dataclasses.replace(
        jnet, link_cost=JCost(jnet.link_cost.family, jnp.asarray(up)))
    runs = [jcore.run(n, jcore.spt_phi_sparse(jnet), n_iters=N_ITERS,
                      method="sparse", driver="host",
                      **run_opts(name, opt, tnet, jnp.asarray))
            for n in (jnet, jnet2)]
    (a, ha), (b, hb) = runs
    for f in PHI_FIELDS:
        d = np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f)))
        print(f, float(d.max()), int((d > 1e-4).sum()))
    print("costs", max(abs(x - y) / abs(y)
                       for x, y in zip(ha["costs"], hb["costs"])))


if __name__ == "__main__":
    if "--write-references" in sys.argv[1:]:
        np.savez_compressed(REFS, **reference_runs())
    if "--ulp-witness" in sys.argv[1:]:
        ulp_witness()
