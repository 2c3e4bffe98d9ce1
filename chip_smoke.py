#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one H100.

    python3 chip_smoke.py

1. Builds the Hopper kernels from `src/repro_torch/kernels/csrc` with
   nvcc (one process per source, all at once) and prints the build time.
2. Holds every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it: `edge_rounds` (K1) on sw_1000's
   padded tiles and on random DAG tiles, `edge_rounds_bucketed` (K2) on
   ba_10000's degree buckets (also against K1 on the same problem), and
   `simplex_project` (K3) on both scenarios' data and result rows.  K1
   and K2 must agree bit for bit, K3 to atol 1e-5 with every row summing
   to 1 or all zero.  Prints the times of each.
3. Drives the main path, Algorithm 1 on the sparse engine for 20
   iterations: sw_1000 padded (K1 + K3) and ba_10000 bucketed (K2 + K3).
   The launch counts must be 2 + 5·n and 2·n for the n iterations
   executed, every cost finite and non-increasing, and the accepted
   costs equal to the JAX reference's golden trajectory
   (`src/repro_torch/data/reference_costs.json`) to rtol 2e-4.
4. Prints one `kernels` JSON line and, last, the device line.

With `--profile` it also traces one more 20-iteration run of each path
with torch.profiler and prints the device time by kernel and the
device's busy share (not part of the checks above).

Exits non-zero on any failure, and when no CUDA device is present.
Every earlier line is a JSON record, except the nvidia-smi line.
"""
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_ITERS = 20
PATHS = (("sw_1000", False), ("ba_10000", True))   # (scenario, bucketed)
# published H100 SXM peaks (dense): HBM3 bytes/s, float32 outside the
# tensor cores; the card's power limit is printed beside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls, CUDA events around each
    call and a synchronize after it (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def substochastic(torch, gen, mask, S, scale):
    """Random φ-like slot weights: rows sum to at most `scale`."""
    w = torch.rand((S,) + tuple(mask.shape), generator=gen,
                   device=mask.device) * mask
    return w * (scale / w.sum(-1, keepdim=True).clamp_min(1.0))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    require(os.path.isdir(os.path.join(src, "repro_torch")),
            "run from the root of a checkout (src/repro_torch missing)")
    sys.path.insert(0, src)
    from repro_torch import core
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.edge_rounds import (edge_rounds_bucketed_cuda,
                                                 edge_rounds_cuda)
    from repro_torch.kernels.simplex_project import simplex_project_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln][:4]
             for name, out in reports.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas})

    # -------------------------------------------------------- scenarios
    nets, nbrs, bks = {}, {}, {}
    for name in ("sw_1000", "ba_10000"):
        t0 = time.perf_counter()
        nets[name] = core.make_scenario(core.TABLE_II[name], device=dev)
        nbrs[name] = core.build_neighbors(nets[name].adj)
        bks[name] = core.build_buckets(nets[name].adj)
        emit({"phase": "scenario", "name": name, "V": nets[name].V,
              "S": nets[name].S, "Dmax": nbrs[name].Dmax,
              "Dmax_in": int(nbrs[name].in_nbr.shape[1]),
              "padded_lanes": nets[name].V * nbrs[name].Dmax,
              "bucket_lanes_out": bks[name].out.lanes,
              "bucket_lanes_in": bks[name].inn.lanes,
              "seconds": time.perf_counter() - t0})

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}     # kernel name -> dict of the headline numbers

    def headline(kname, **kv):
        row = results.setdefault(kname, {"max_abs_err": 0.0})
        err = kv.pop("max_abs_err")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if kv.get("main"):
            row.update({k: v for k, v in kv.items() if k != "main"})

    # ------------------------------------------------- K1 edge_rounds
    def k1_case(label, w, b, nbr, mask, reduce, shift, main=False):
        V, D = nbr.shape
        nbr32, mask8 = nbr.to(torch.int32), mask.to(torch.uint8)
        x, rounds = edge_rounds_cuda(w, b, nbr32, mask8, reduce, shift)
        torch.cuda.synchronize()
        xr, kr = ref.edge_rounds_ref(w, b, nbr, mask, reduce, shift)
        require(torch.equal(x, xr), f"K1 {label}: kernel != plain")
        require(int(rounds.max()) == kr, f"K1 {label}: rounds "
                f"{int(rounds.max())} != plain {kr}")
        ms = time_ms(torch, lambda: edge_rounds_cuda(
            w, b, nbr32, mask8, reduce, shift), 20)
        plain = time_ms(torch, lambda: ref.edge_rounds_ref(
            w, b, nbr, mask, reduce, shift), 3)
        n_bytes = (w.numel() * w.element_size() + b.numel() * b.element_size()
                   + V * D * 5 + x.numel() * x.element_size())
        n_ops = 3.0 * float(rounds.sum()) * V * D
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "edge_rounds", "case": label,
              "shape": list(w.shape), "dtype": str(w.dtype),
              "reduce": reduce, "shift": shift, "bitwise": True,
              "rounds_max": int(rounds.max()), "ms": ms, "plain_ms": plain,
              "bound_ms": bms, "bound_by": by})
        headline("edge_rounds", max_abs_err=0.0, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    net, nb = nets["sw_1000"], nbrs["sw_1000"]
    S, V = net.S, net.V
    w_out = substochastic(torch, gen, nb.out_mask, S, 0.9)
    w_in = w_out[:, nb.in_nbr, nb.in_slot]
    k1_case("sw_1000 traffic (in-edges)", w_in, net.r, nb.in_nbr,
            nb.in_mask, "sum", 0.0, main=True)
    k1_case("sw_1000 marginals (out-edges)", w_out,
            torch.rand((S, V), generator=gen, device=dev), nb.out_nbr,
            nb.out_mask, "sum", 0.0)
    sup = (torch.rand((2 * S, V, nb.Dmax), generator=gen, device=dev)
           < 0.3) & nb.out_mask
    seeds = torch.rand((2 * S, V), generator=gen, device=dev) < 0.02
    for dt in (torch.float32, torch.bfloat16):
        k1_case(f"sw_1000 taint pair max {dt}", sup.to(dt), seeds.to(dt),
                nb.out_nbr, nb.out_mask, "max", 0.0)
    dag = nb.out_mask & (nb.out_nbr > torch.arange(V, device=dev)[:, None])
    k1_case("sw_1000 longest path max shift=1", dag.float()[None].expand(
        S, V, nb.Dmax).contiguous(), torch.zeros((S, V), device=dev),
        nb.out_nbr, nb.out_mask, "max", 1.0)
    gen_cpu = torch.Generator().manual_seed(1)
    adj = torch.triu(torch.rand((V, V), generator=gen_cpu) < 0.01, 1)
    dnb = core.build_neighbors(adj, device=dev)
    k1_case("random DAG V=1000", substochastic(torch, gen, dnb.out_mask, S,
                                               1.0),
            torch.rand((S, V), generator=gen, device=dev), dnb.out_nbr,
            dnb.out_mask, "sum", 0.0)

    # ------------------------------------------ K2 edge_rounds_bucketed
    net, nb, bk = nets["ba_10000"], nbrs["ba_10000"], bks["ba_10000"]
    S, V = net.S, net.V

    def k2_case(label, w, b, eb, nbr, mask, w_pad, reduce, main=False):
        x, rounds = edge_rounds_bucketed_cuda(w, b, eb, reduce)
        torch.cuda.synchronize()
        xr, kr = ref.edge_rounds_bucketed_ref(w, b, eb, reduce)
        xp, kp = edge_rounds_cuda(w_pad, b, nbr.to(torch.int32),
                                  mask.to(torch.uint8), reduce)
        torch.cuda.synchronize()
        require(torch.equal(x, xr), f"K2 {label}: kernel != plain")
        require(torch.equal(x, xp), f"K2 {label}: bucketed != padded K1")
        require(int(rounds.max()) == kr == int(kp.max()),
                f"K2 {label}: round counts differ")
        ms = time_ms(torch, lambda: edge_rounds_bucketed_cuda(
            w, b, eb, reduce), 20)
        plain = time_ms(torch, lambda: ref.edge_rounds_bucketed_ref(
            w, b, eb, reduce), 3)
        k1_ms = time_ms(torch, lambda: edge_rounds_cuda(
            w_pad, b, nbr.to(torch.int32), mask.to(torch.uint8), reduce), 5)
        lanes = eb.lanes
        n_bytes = (S * lanes * w.element_size() + lanes * 13 + V * 4
                   + b.numel() * b.element_size()
                   + x.numel() * x.element_size())
        n_ops = 3.0 * float(rounds.sum()) * lanes
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "edge_rounds_bucketed",
              "case": label, "shape": list(w.shape), "dtype": str(w.dtype),
              "lanes": lanes, "reduce": reduce, "bitwise": True,
              "rounds_max": int(rounds.max()), "ms": ms, "plain_ms": plain,
              "padded_k1_ms": k1_ms, "bound_ms": bms, "bound_by": by})
        headline("edge_rounds_bucketed", max_abs_err=0.0, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    w_out = substochastic(torch, gen, nb.out_mask, S, 0.9)
    k2_case("ba_10000 traffic (in buckets)", w_out, net.r, bk.inn,
            nb.in_nbr, nb.in_mask, w_out[:, nb.in_nbr, nb.in_slot], "sum",
            main=True)
    k2_case("ba_10000 marginals (out buckets)", w_out,
            torch.rand((S, V), generator=gen, device=dev), bk.out,
            nb.out_nbr, nb.out_mask, w_out, "sum")
    sup = ((torch.rand((2 * S, V, nb.Dmax), generator=gen, device=dev)
            < 0.3) & nb.out_mask).to(torch.bfloat16)
    seeds = (torch.rand((2 * S, V), generator=gen, device=dev)
             < 0.02).to(torch.bfloat16)
    k2_case("ba_10000 taint pair max bf16", sup, seeds, bk.out, nb.out_nbr,
            nb.out_mask, sup, "max")

    # ------------------------------------------------ K3 simplex_project
    def k3_case(label, R, K, main=False):
        phi = torch.rand((R, K), generator=gen, device=dev)
        phi = phi / phi.sum(-1, keepdim=True)
        delta = torch.rand((R, K), generator=gen, device=dev) * 3
        M = torch.rand((R, K), generator=gen, device=dev) * 2 + 0.25
        M[::5] = 1e-14
        perm = torch.rand((R, K), generator=gen, device=dev) < 0.7
        perm[::11] = False
        out = simplex_project_cuda(phi, delta, M, perm)
        torch.cuda.synchronize()
        want = ref.simplex_project_ref(phi, delta, M, perm)
        err = float((out - want).abs().max())
        require(err <= 1e-5, f"K3 {label}: max abs err {err} > 1e-5")
        sums = out.sum(-1)
        live = perm.any(-1)
        require(bool(((sums[live] - 1).abs() <= 1e-5).all()),
                f"K3 {label}: a permitted row does not sum to 1")
        require(bool((out[~live] == 0).all()),
                f"K3 {label}: a blocked row is not all zero")
        ms = time_ms(torch, lambda: simplex_project_cuda(phi, delta, M,
                                                         perm), 20)
        plain = time_ms(torch, lambda: ref.simplex_project_ref(
            phi, delta, M, perm), 3)
        halvings = bisection_halvings(torch, ref, phi, delta, M, perm)
        n_bytes = R * K * (4 * 4 + 1)
        n_ops = 3.0 * halvings * K + 12.0 * R * K
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "simplex_project", "case": label,
              "shape": [R, K], "max_abs_err": err,
              "mean_halvings": halvings / R, "ms": ms, "plain_ms": plain,
              "bound_ms": bms, "bound_by": by})
        headline("simplex_project", max_abs_err=err, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    for name in ("sw_1000", "ba_10000"):
        R, D = nets[name].S * nets[name].V, nbrs[name].Dmax
        k3_case(f"{name} data rows", R, D + 1, main=(name == "ba_10000"))
        k3_case(f"{name} result rows", R, D)

    # -------------------------------------------------------- main path
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_costs.json")) as f:
        golden = json.load(f)
    path_launches = {}
    for name, bucketed in PATHS:
        net = nets[name]
        phi0 = core.spt_phi_sparse(net, nbrs[name])
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        _, hist = core.run(net, phi0, n_iters=N_ITERS, bucketed=bucketed,
                           nbrs=nbrs[name],
                           buckets=bks[name] if bucketed else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launches()
        costs = hist["costs"]
        n_exec = len(costs) - 1 + hist["n_rejected"]
        rounds_kernel = "edge_rounds_bucketed" if bucketed else "edge_rounds"
        want = {"edge_rounds": 0, "edge_rounds_bucketed": 0,
                rounds_kernel: 2 + 5 * n_exec, "simplex_project": 2 * n_exec}
        require(counts == want, f"{name}: launches {counts} != {want}")
        require(all(map(math.isfinite, costs)), f"{name}: a cost is not "
                "finite")
        require(all(b <= a for a, b in zip(costs, costs[1:])),
                f"{name}: an accepted cost rose")
        ref_costs = golden[name]["costs"]
        require(len(costs) == len(ref_costs)
                and hist["n_rejected"] == golden[name]["n_rejected"],
                f"{name}: {len(costs)} costs / {hist['n_rejected']} "
                f"rejections vs the reference's {len(ref_costs)} / "
                f"{golden[name]['n_rejected']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(costs, ref_costs))
        require(rel <= 2e-4, f"{name}: costs differ from the reference by "
                f"rtol {rel}")
        for k, v in counts.items():
            path_launches[k] = path_launches.get(k, 0) + v
        emit({"phase": "main_path", "scenario": name, "bucketed": bucketed,
              "iterations": n_exec, "rejected": hist["n_rejected"],
              "launches": counts, "seconds": seconds,
              "ms_per_iteration": seconds * 1e3 / n_exec,
              "first_cost": costs[0], "final_cost": costs[-1],
              "max_rel_err_vs_reference": rel})
    for k, v in path_launches.items():
        require(v > 0, f"kernel {k} was never launched on the main path")

    require("jax" not in sys.modules, "jax was imported")
    sources = {"edge_rounds": ("src/repro_torch/kernels/csrc/edge_rounds.cu",
                               "src/repro/kernels/edge_rounds.py:81"),
               "edge_rounds_bucketed": (
                   "src/repro_torch/kernels/csrc/edge_rounds.cu",
                   "src/repro/kernels/edge_rounds.py:173"),
               "simplex_project": (
                   "src/repro_torch/kernels/csrc/simplex_project.cu",
                   "src/repro/kernels/simplex_project.py:76")}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": path_launches[k],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"], "library_ms": None}
        for k in sources]})
    if "--profile" in sys.argv[1:]:
        profile_paths(torch, core, nets, nbrs, bks)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_paths(torch, core, nets, nbrs, bks, top=12):
    """Device time by kernel name and the device's busy share over one
    traced 20-iteration run of each main path."""
    from torch.profiler import ProfilerActivity, profile
    for name, bucketed in PATHS:
        phi0 = core.spt_phi_sparse(nets[name], nbrs[name])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            core.run(nets[name], phi0, n_iters=N_ITERS, bucketed=bucketed,
                     nbrs=nbrs[name], buckets=bks[name] if bucketed else None)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): a CPU op's row also
        # carries its kernels' time; CUPTI's own buffer requests are no
        # device work
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0
                and e.key != "Activity Buffer Request"]
        device_ms = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        emit({"phase": "profile", "scenario": name, "wall_ms": wall_ms,
              "device_ms": device_ms,
              "busy_share": device_ms / wall_ms if wall_ms else None,
              "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                      for k, ms, n in rows[:top]]})


def bisection_halvings(torch, ref, phi, delta, M, perm, n_iter=60):
    """Halvings the rows of this input need: each row counts until its
    own bracket stops moving (the oracle's loop, row by row)."""
    q, w, _, lo, hi = ref.dual_setup(phi, delta, M, perm)
    live = torch.ones_like(lo, dtype=torch.bool)
    total = torch.zeros((), dtype=torch.float64, device=phi.device)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        up = torch.clamp_min(q - mid * w, 0.0).sum(-1, keepdim=True) > 1.0
        lo2, hi2 = torch.where(up, mid, lo), torch.where(up, hi, mid)
        total += live.sum()
        live = live & ((lo2 != lo) | (hi2 != hi))
        lo, hi = lo2, hi2
        if not bool(live.any()):
            break
    return float(total)


if __name__ == "__main__":
    sys.exit(main())
