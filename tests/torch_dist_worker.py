"""One rank of the 2-rank gloo job of `test_torch_distributed.py`: every
multi-rank check, its results written as JSON.  Kept apart from the test
file so that each spawned rank imports only torch and the port.

    PYTHONPATH=src python tests/torch_dist_worker.py RANK PORT OUT_DIR
"""
import json
import os
import sys

import torch

N_ITERS = 20


def odd_abilene(tcore, device="cpu"):
    """abilene with its last task dropped (S = 9: two ranks pad one)."""
    import dataclasses
    net = tcore.make_scenario(tcore.TABLE_II["abilene"], device=device)
    keep = slice(0, net.S - 1)
    return dataclasses.replace(
        net, dest=net.dest[keep], r=net.r[keep], a=net.a[keep],
        w=net.w[keep], task_type=net.task_type[keep])


def _phi_arrays(phi):
    return {f: getattr(phi, f).cpu().numpy().tolist()
            for f in ("data", "local", "result") if hasattr(phi, f)}


# ------------------------------------------------------------ the worker
def worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the 2-rank gloo job: every multi-rank check, its
    results written to `out_dir/rank{rank}.json`."""
    import torch.distributed as dist
    from repro_torch import core as tcore
    from repro_torch.convert import distributed_phi_to_numpy
    from repro_torch.core import distributed as tdist
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.guards import GuardConfig
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    out = {}
    mesh = tdist.task_mesh(device="cpu")
    out["mesh"] = [mesh.rank, mesh.size]
    net = odd_abilene(tcore)
    phi_sp = tcore.spt_phi_sparse(net)
    runs = {}
    for drv in ("host", "fused"):
        phi, h = tcore.run_distributed(net, phi_sp, n_iters=N_ITERS,
                                       method="sparse", driver=drv,
                                       mesh=mesh)
        runs[drv] = (phi, h)
    (ph, hh), (pf, hf) = runs["host"], runs["fused"]
    out["sparse"] = {"costs": hh["costs"], "n_rejected": hh["n_rejected"],
                     "phi": _phi_arrays(ph)}
    out["fused_equals_host"] = (
        hh["costs"] == hf["costs"] and hh["n_rejected"] == hf["n_rejected"]
        and all(torch.equal(getattr(ph, f), getattr(pf, f))
                for f in ("data", "local", "result")))
    st = tdist.init_distributed_state(net, phi_sp, method="sparse",
                                      mesh=mesh)
    data, local, result = distributed_phi_to_numpy(st)
    out["padded"] = {"S": st.S, "shape": list(data.shape),
                     "pad_local": local[9].tolist(),
                     "pad_mass": float(abs(data[9]).sum()
                                       + abs(result[9]).sum())}
    phi_d, hd = tcore.run_distributed(net, tcore.spt_phi(net),
                                      n_iters=N_ITERS, method="dense",
                                      driver="host", mesh=mesh)
    out["dense"] = {"costs": hd["costs"], "n_rejected": hd["n_rejected"],
                    "phi": _phi_arrays(phi_d)}
    # faults and guards over two ranks: every rank draws alike, one
    # applies each corruption, the sentinels reduce over both
    _, hg = tcore.run_distributed(
        net, phi_sp, n_iters=12, method="sparse",
        fault_plan=FaultPlan(participation_p=0.7, corrupt_p=0.5),
        fault_rng=torch.Generator().manual_seed(2),
        guards=GuardConfig(checkpoint_every=2, max_retries=64), mesh=mesh)
    out["guarded"] = {"costs": hg["costs"], "n_corrupt": hg["n_corrupt"],
                      "trips": [(e.it, e.sentinel, e.action)
                                for e in hg["guard_events"]]}
    # the node-sharded measurement at 2 node shards
    fog = tcore.make_scenario(tcore.TABLE_II["fog"], device="cpu")
    nbrs = tcore.build_neighbors(fog.adj)
    phi_f = tcore.spt_phi_sparse(fog, nbrs)
    nmesh = tdist.task_node_mesh(1, 2, device="cpu")
    carry, cost = tdist.node_flows_carry_and_cost(fog, phi_f, nbrs, nmesh)
    ref, ref_cost = tcore.flows_carry_and_cost(fog, phi_f, "sparse",
                                               nbrs=nbrs)
    out["node"] = {
        "shape": nmesh.shape,
        "traffic_bitwise": bool(torch.equal(carry.t_data, ref.t_data)
                                and torch.equal(carry.t_result,
                                                ref.t_result)),
        "F_rel": float(((carry.F - ref.F).abs().max()
                        / ref.F.abs().max())),
        "G_rel": float(((carry.G - ref.G).abs().max()
                        / ref.G.abs().max())),
        "cost": float(cost), "ref_cost": float(ref_cost)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
