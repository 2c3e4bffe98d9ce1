#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one H100.

    python3 chip_smoke.py [--profile]

1. Builds the Hopper kernels from `src/repro_torch/kernels/csrc` with
   nvcc (one process per source, all at once) and prints the build time
   and each source's registers and spills.
2. Holds every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it: `edge_rounds` (K1) on sw_1000's padded
   tiles, on random DAG tiles and on the seven solves of the sparse main
   path's first iteration (operands recorded from `core.run`),
   `edge_rounds_bucketed` (K2) on ba_10000's degree buckets (also
   against K1 on the same problem; each K1 and K2 record carries the
   cluster of CTAs a task row got), `simplex_project` (K3) on both
   scenarios' data and result rows under a random mask and on the two
   QPs of each main path's first iteration, both bit for bit with equal
   rounds (K1, K2) or to atol 1e-5 with every row summing to 1 or all
   zero (K3; its bound counts 5 bytes a coordinate and 12 more a
   permitted one); `flash_attention` (K4) on Qwen3-0.6B's prefill,
   q [1, 16, L, 128] against k, v [1, 8, L, 128], causal, L in {17, 128,
   333, 512}, and on OLMoE's, k, v [1, 16, L, 128], L in {17, 333, 512},
   and `decode_attention` (K5) on their decode steps, q [8, 8, 2, 128]
   against [8, 1024, 8, 128] caches and q [8, 16, 1, 128] against
   [8, 1024, 16, 128], with ragged lengths from 1 to 1024, every
   length 1, every length 1024, and one request (B = 1) of length 1024
   (and off the path at hd 50, G = 3), all in float32 (rtol = atol =
   2e-4) and bfloat16 (2e-2), then both captured in one CUDA graph and
   replayed on new inputs and lengths (2e-2); `ssd_scan`
   (K6) on Mamba2-130M's prefill, x [B, L, 24, 64], dt [B, L, 24], A
   [24], B/C [B, L, 128], L in {17, 128, 256, 512} at B = 1 and L = 256
   at B = 4, float32 and bfloat16, plus one float32 case from an initial
   state: y to 1e-4 (float32) or 1e-2 (bfloat16, one ulp) and the final
   state to 1e-4; `moe_gmm` (K7) on OLMoE's expert products, [64, C,
   2048] @ [64, 2048, 1024] and [64, C, 1024] @ [64, 1024, 2048] at
   C in {4, 52, 80}, plus two ragged shapes, in float32 (rtol 1e-5 of
   Σ|x·w|) and bfloat16 (one ulp), at C = 4 also with 40 of 64 experts
   `active` (equal to the dense kernel bit for bit), and one launch with
   `active` replayed from a CUDA graph on new inputs and active sets.
   Prints the times of each, and for K4 and K5 that of PyTorch's
   scaled_dot_product_attention, for K7 that of torch.bmm, on the same
   inputs as a yardstick (no PyTorch call computes K6's function); K1,
   K3 and K4–K7 are timed by the profiler's device time (for K4 and K5
   CUDA events around the run are printed beside it, and the kernel's
   ratio to SDPA), K2 by CUDA events.
3. Drives the sparse main path, Algorithm 1 for 20 iterations: sw_1000
   padded (K1 + K3) and ba_10000 bucketed (K2 + K3).  The launch counts
   must be 2 + 5·n and 2·n for the n iterations executed, every cost
   finite and non-increasing, and the accepted costs equal to the JAX
   reference's golden trajectory (`src/repro_torch/data/
   reference_costs.json`) to rtol 2e-4.  A traced 3-iteration run then
   gives K1, K2 and K3's device time a launch on the path's own inputs.
4. Serves Qwen3-0.6B (28 layers), then Mamba2-130M (24 layers), at full
   width through `ServingEngine`, random weights from SERVE_SEED: 12
   requests on 8 slots, max_len 1024, 32 new tokens (Mamba2's prompts
   are 16-256 tokens, two of them 512: the chunk contract).  In float32
   (TF32 off) the tokens must equal the JAX engine's
   (`src/repro_torch/data/reference_serve.json`,
   `reference_serve_mamba2.json`) and the logits at its top-5 indices
   hold to rtol 1e-3; a token may differ only where the stored top-2
   margin is under that tolerance, and the request's comparison stops
   there.  In bfloat16 the same requests run through the kernels,
   timed: per layer one K4 launch per prefill and one K5 per decode
   step (Qwen3), one K6 per prefill and none per decode step (Mamba2),
   no other kernel, every request done with the output length its
   budget and EOS dictate; prints prefill ms per request, decode ms per
   step, tokens/s and peak memory.  Then, with every logits row kept,
   they run through the kernels again (the same tokens), with the plain
   versions forced (`impl="ref"`), and with the witness: the plain
   versions taking their float32 sums in another order (attention over
   the keys in reverse order; the SSD as `ssd_sequential`, token by
   token).  At the prefill and at each decode step until the tokens
   part, the kernels' logits may be no further from the plain run's
   than 1.5 times the witness's, in max abs and in relative L2; whether
   they are within 2e-2 is printed.
5. Serves OLMoE-1B-7B at full width, the same requests and settings,
   with the router's load EMAs as the model state.  Float32 at
   OLMOE_F32_LAYERS layers against `reference_serve_olmoe.json`, call
   by call in the engine's order; the EMAs are engine-global, so the
   first call that fails ends the comparison and passes only at a
   routing near-tie (the call's smallest gap between a token's K-th
   and (K+1)-th selection logits under 1e-4 of max(1, |K-th|)) or a
   top-2 near-tie; with none the final EMAs hold to rtol 1e-5.  The
   smallest router gap of the run is printed.  Bfloat16 at all 16
   layers, weights drawn on the card with a torch.Generator: per layer
   one K4 and three K7 per prefill, one K5 and three K7 per decode
   step; then the plain versions choose the tokens and at every call
   the kernels and the witness (keys and the gmm's D reversed) take the
   same inputs, the kernels held to 1.5 times the witness's distance.
6. Prints one `kernels` JSON line and, last, the device line.

With `--profile` it also traces one more 20-iteration run of each sparse
path, and one bfloat16 serve of each of the three models, with
torch.profiler and
prints the device time by kernel and the device's busy share (not part
of the checks above).

Exits non-zero on any failure, and when no CUDA device is present.
Every earlier line is a JSON record, except the nvidia-smi line.
"""
import contextlib
import gc
import inspect
import itertools
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
PEAK_BF16_FLOPS = 989e12
# the serving phases: Qwen3-0.6B at full width, the requests and the
# reference tokens and logits of src/repro_torch/data/reference_serve.json
SERVE_ARCH = "qwen3-0.6b"
SERVE_SEED = 0
SERVE_REQUESTS = 12
SERVE_CONFIG = {"max_slots": 8, "max_len": 1024, "max_new_tokens": 32,
                "eos_id": 1}
# the Mamba2 serving phases: mamba2-130m at full width, the same seed and
# engine settings, the requests of reference_serve_mamba2.json
MAMBA_ARCH = "mamba2-130m"
MAMBA_REQUESTS = 12
# K6's own chunk (csrc/ssd_scan.cu, kQ): its operation count in bound_ms
SSD_KERNEL_CHUNK = 64
# the OLMoE serving phases: olmoe-1b-7b at full width, the same seed,
# engine settings and request recipe; float32 at OLMOE_F32_LAYERS layers
# against reference_serve_olmoe.json, bfloat16 at all 16
OLMOE_ARCH = "olmoe-1b-7b"
OLMOE_REQUESTS = 12
OLMOE_F32_LAYERS = 4
# the names of the kernels under src/repro_torch/kernels/csrc, as the
# profiler reports them after "(anonymous namespace)::"
PORT_KERNEL_PREFIXES = ("edge_rounds", "simplex_project", "flash_fwd",
                        "decode_split", "ssd_scan", "gmm_")


T0 = time.perf_counter()


def emit(record: dict) -> None:
    """One JSON line; a phase's record carries the seconds since start."""
    if "phase" in record:
        record = {**record, "at_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(record), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls, one pair
    of CUDA events around the run (one warm-up call first), so the host's
    launch overhead hides behind the queued work wherever it can."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Device time of `fn` per call: the kernels (and copies) it launches,
    summed by torch.profiler over `reps` calls (one warm-up call
    first).  Unlike CUDA events around back-to-back calls, this leaves
    out the host's launch time when a call's kernels are shorter than
    it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler can hand back no device events for a window: take it
    # again, longer, and fail rather than report 0 ms
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(e.self_device_time_total for e in events
                    if str(e.device_type).endswith("CUDA")
                    and e.key != "Activity Buffer Request")
        if total > 0:
            return total / 1e3 / reps
        kinds = {}
        for e in events:
            kinds[str(e.device_type)] = kinds.get(str(e.device_type), 0) + 1
        emit({"phase": "profiler_window_empty", "attempt": attempt,
              "reps": reps, "event_kinds": kinds})
        reps *= 4
        time.sleep(1.0)
    raise RuntimeError("the profiler recorded no device time in five "
                       "windows")


def substochastic(torch, gen, mask, S, scale):
    """Random φ-like slot weights: rows sum to at most `scale`."""
    w = torch.rand((S,) + tuple(mask.shape), generator=gen,
                   device=mask.device) * mask
    return w * (scale / w.sum(-1, keepdim=True).clamp_min(1.0))


def golden_costs(src) -> dict:
    """The JAX reference's main-path trajectories, by scenario."""
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_costs.json")) as f:
        return json.load(f)


def check_costs(label, hist, want) -> float:
    """Holds one `core.run` history to its golden trajectory `want`: every
    cost finite and non-increasing, the same accepted steps and
    rejections, the costs to rtol 2e-4.  Returns the largest relative
    difference."""
    costs, ref_costs = hist["costs"], want["costs"]
    require(all(map(math.isfinite, costs)), f"{label}: a cost is not "
            "finite")
    require(all(b <= a for a, b in zip(costs, costs[1:])),
            f"{label}: an accepted cost rose")
    require(len(costs) == len(ref_costs)
            and hist["n_rejected"] == want["n_rejected"],
            f"{label}: {len(costs)} costs / {hist['n_rejected']} "
            f"rejections vs the reference's {len(ref_costs)} / "
            f"{want['n_rejected']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(costs, ref_costs))
    require(rel <= 2e-4, f"{label}: costs differ from the reference by "
            f"rtol {rel}")
    return rel


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
    from repro_torch.kernels.edge_rounds import (cluster_plan, cluster_size,
                                                 edge_rounds_bucketed_cuda,
                                                 edge_rounds_cuda, k1_plan)
    from repro_torch.kernels.simplex_project import (rows_per_warp,
                                                     simplex_project_cuda)

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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          "ptxas": {name: ptxas_summary(out)
                    for name, out in reports.items()}})

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
    def k1_case(label, w, b, nbr32, mask8, reduce, shift, max_rounds=None,
                main=False):
        V, D = nbr32.shape
        plan = k1_plan(w.shape[0], V, D)
        x, rounds = edge_rounds_cuda(w, b, nbr32, mask8, reduce, shift,
                                     max_rounds)
        torch.cuda.synchronize()
        xr, kr = ref.edge_rounds_ref(w, b, nbr32.long(), mask8.bool(),
                                     reduce, shift, max_rounds)
        require(torch.equal(x, xr), f"K1 {label}: kernel != plain")
        require(int(rounds.max()) == kr, f"K1 {label}: rounds "
                f"{int(rounds.max())} != plain {kr}")
        ms = device_ms(torch, lambda: edge_rounds_cuda(
            w, b, nbr32, mask8, reduce, shift, max_rounds), 20)
        plain = time_ms(torch, lambda: ref.edge_rounds_ref(
            w, b, nbr32.long(), mask8.bool(), reduce, shift, max_rounds), 3)
        n_bytes = (w.numel() * w.element_size() + b.numel() * b.element_size()
                   + V * D * 5 + x.numel() * x.element_size())
        n_ops = 3.0 * float(rounds.sum()) * V * D
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "edge_rounds", "case": label,
              "shape": list(w.shape), "dtype": str(w.dtype),
              "reduce": reduce, "shift": shift, "bitwise": True,
              "cluster": plan.size, "tiles_in_smem": plan.tiles,
              "slots_a_lane": plan.slots_a_lane(D),
              "smem_bytes_per_cta": plan.smem_bytes(D),
              "rounds_max": int(rounds.max()), "ms": ms, "plain_ms": plain,
              "bound_ms": bms, "bound_by": by})
        headline("edge_rounds", max_abs_err=0.0, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    # the operands of core.run's first iteration on both paths
    path_ops = {name: record_path_operands(torch, core, ops, nets[name],
                                           nbrs[name], bks[name], bucketed)
                for name, bucketed in PATHS}
    for i, (w, b, nbr32, mask8, reduce, shift, max_rounds) in enumerate(
            path_ops["sw_1000"]["edge_rounds"]):
        k1_case(f"sw_1000 path call {i} ({reduce})", w, b, nbr32, mask8,
                reduce, shift, max_rounds)

    net, nb = nets["sw_1000"], nbrs["sw_1000"]
    S, V = net.S, net.V
    w_out = substochastic(torch, gen, nb.out_mask, S, 0.9)
    w_in = w_out[:, nb.in_nbr, nb.in_slot]
    i32, u8 = torch.int32, torch.uint8
    k1_case("sw_1000 traffic (in-edges)", w_in, net.r, nb.in_nbr.to(i32),
            nb.in_mask.to(u8), "sum", 0.0, main=True)
    k1_case("sw_1000 marginals (out-edges)", w_out,
            torch.rand((S, V), generator=gen, device=dev),
            nb.out_nbr.to(i32), nb.out_mask.to(u8), "sum", 0.0)
    sup = (torch.rand((2 * S, V, nb.Dmax), generator=gen, device=dev)
           < 0.3) & nb.out_mask
    seeds = torch.rand((2 * S, V), generator=gen, device=dev) < 0.02
    for dt in (torch.float32, torch.bfloat16):
        k1_case(f"sw_1000 taint pair max {dt}", sup.to(dt), seeds.to(dt),
                nb.out_nbr.to(i32), nb.out_mask.to(u8), "max", 0.0)
    dag = nb.out_mask & (nb.out_nbr > torch.arange(V, device=dev)[:, None])
    k1_case("sw_1000 longest path max shift=1", dag.float()[None].expand(
        S, V, nb.Dmax).contiguous(), torch.zeros((S, V), device=dev),
        nb.out_nbr.to(i32), nb.out_mask.to(u8), "max", 1.0)
    gen_cpu = torch.Generator().manual_seed(1)
    adj = torch.triu(torch.rand((V, V), generator=gen_cpu) < 0.01, 1)
    dnb = core.build_neighbors(adj, device=dev)
    k1_case("random DAG V=1000", substochastic(torch, gen, dnb.out_mask, S,
                                               1.0),
            torch.rand((S, V), generator=gen, device=dev),
            dnb.out_nbr.to(i32), dnb.out_mask.to(u8), "sum", 0.0)

    # ------------------------------------------ K2 edge_rounds_bucketed
    net, nb, bk = nets["ba_10000"], nbrs["ba_10000"], bks["ba_10000"]
    S, V = net.S, net.V

    def k2_case(label, w, b, eb, nbr, mask, w_pad, reduce, main=False):
        plan = cluster_plan(eb, cluster_size(w.shape[0], eb.lanes))
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
              "lanes": lanes, "cluster": plan.size,
              "smem_bytes_per_cta": plan.smem_bytes, "reduce": reduce,
              "bitwise": True,
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
    def k3_case(label, phi, delta, M, perm, main=False):
        R, K = phi.shape
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
        ms = device_ms(torch, lambda: simplex_project_cuda(phi, delta, M,
                                                           perm), 20)
        plain = time_ms(torch, lambda: ref.simplex_project_ref(
            phi, delta, M, perm), 3)
        n_perm = perm.sum(-1)
        halvings, work = bisection_halvings(torch, ref, phi, delta, M, perm,
                                            weight=n_perm)
        # the mask read and the output written once a coordinate; φ, δ and
        # M read where permitted; 3 flops a permitted coordinate a halving
        permitted = int(n_perm.sum())
        n_bytes = R * K * 5 + 12 * permitted
        n_ops = 3.0 * work + 12.0 * permitted
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "simplex_project", "case": label,
              "shape": [R, K], "max_abs_err": err,
              "rows_per_warp": rows_per_warp(K), "permitted": permitted,
              "max_permitted_a_row": int(n_perm.max()),
              "mean_halvings": halvings / R, "ms": ms, "plain_ms": plain,
              "bound_ms": bms, "bound_by": by})
        headline("simplex_project", max_abs_err=err, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    for name in ("sw_1000", "ba_10000"):
        R, D = nets[name].S * nets[name].V, nbrs[name].Dmax
        for label, K in (("data", D + 1), ("result", D)):
            phi = torch.rand((R, K), generator=gen, device=dev)
            phi = phi / phi.sum(-1, keepdim=True)
            delta = torch.rand((R, K), generator=gen, device=dev) * 3
            M = torch.rand((R, K), generator=gen, device=dev) * 2 + 0.25
            M[::5] = 1e-14
            perm = torch.rand((R, K), generator=gen, device=dev) < 0.7
            perm[::11] = False
            k3_case(f"{name} {label} rows (random 70 % mask)", phi, delta,
                    M, perm, main=(name == "ba_10000" and label == "data"))
        for i, args in enumerate(path_ops[name]["simplex_project"]):
            k3_case(f"{name} path call {i} ({'data' if i == 0 else 'result'}"
                    " rows)", *args[:4])

    # ------------------------------------- K4 flash / K5 decode attention
    attention_kernel_checks(torch, emit_kernel=headline)
    # ------------------------------------------------------ K6 ssd_scan
    ssd_kernel_checks(torch, emit_kernel=headline)
    # ------------------------------------------------------- K7 moe_gmm
    gmm_kernel_checks(torch, emit_kernel=headline)

    # -------------------------------------------------------- main path
    golden = golden_costs(src)
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
        want = {k: 0 for k in counts}
        want.update({rounds_kernel: 2 + 5 * n_exec,
                     "simplex_project": 2 * n_exec})
        require(counts == want, f"{name}: launches {counts} != {want}")
        rel = check_costs(name, hist, golden[name])
        for k in ("edge_rounds", "edge_rounds_bucketed", "simplex_project"):
            path_launches[k] = path_launches.get(k, 0) + counts[k]
        emit({"phase": "main_path", "scenario": name, "bucketed": bucketed,
              "iterations": n_exec, "rejected": hist["n_rejected"],
              "launches": counts, "seconds": seconds,
              "ms_per_iteration": seconds * 1e3 / n_exec,
              "first_cost": costs[0], "final_cost": costs[-1],
              "max_rel_err_vs_reference": rel,
              "warm_launch_ms": path_launch_ms(torch, core, net, phi0,
                                               nbrs[name], bks[name],
                                               bucketed)})
    # ------------------------------------- serving Qwen3-0.6B, Mamba2-130M
    serve_counts, serve_bf16 = serve_checks(
        torch, src, SERVE_ARCH, "reference_serve.json", SERVE_REQUESTS,
        witness=reversed_keys, per_prefill={"flash_attention": 1},
        per_decode={"decode_attention": 1})
    path_launches.update(serve_counts)
    mamba_counts, mamba_bf16 = serve_checks(
        torch, src, MAMBA_ARCH, "reference_serve_mamba2.json",
        MAMBA_REQUESTS, witness=sequential_ssd, per_prefill={"ssd_scan": 1},
        per_decode={})
    path_launches.update(mamba_counts)
    # ------------------------------------------------ serving OLMoE-1B-7B
    olmoe_counts, olmoe_bf16 = olmoe_serve_checks(torch, src)
    path_launches["moe_gmm"] = olmoe_counts["moe_gmm"]
    for k, v in path_launches.items():
        require(v > 0, f"kernel {k} was never launched on its path")

    require("jax" not in sys.modules, "jax was imported")
    sources = {"edge_rounds": ("src/repro_torch/kernels/csrc/edge_rounds.cu",
                               "src/repro/kernels/edge_rounds.py:81"),
               "edge_rounds_bucketed": (
                   "src/repro_torch/kernels/csrc/edge_rounds.cu",
                   "src/repro/kernels/edge_rounds.py:173"),
               "simplex_project": (
                   "src/repro_torch/kernels/csrc/simplex_project.cu",
                   "src/repro/kernels/simplex_project.py:76"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:68"),
               "decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:62"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:80"),
               "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                           "src/repro/kernels/moe_gmm.py:35")}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": path_launches[k],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k].get("library_ms")}
        for k in sources]})
    if "--profile" in sys.argv[1:]:
        profile_paths(torch, core, nets, nbrs, bks)
        profile_decode(torch, *serve_bf16, label=f"serve {SERVE_ARCH} "
                       "bfloat16")
        profile_decode(torch, *mamba_bf16, label=f"serve {MAMBA_ARCH} "
                       "bfloat16")
        profile_decode(torch, *olmoe_bf16, label=f"serve {OLMOE_ARCH} "
                       "bfloat16")
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
        # each port kernel over all its template instantiations
        port = {k: {"ms": sum(ms for key, ms, _ in rows if tag in key),
                    "calls": sum(n for key, _, n in rows if tag in key)}
                for k, tag in PATH_KERNEL_NAMES.items()}
        emit({"phase": "profile", "scenario": name, "wall_ms": wall_ms,
              "device_ms": device_ms,
              "busy_share": device_ms / wall_ms if wall_ms else None,
              "port_kernels": {k: v for k, v in port.items() if v["calls"]},
              "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                      for k, ms, n in rows[:top]]})


# the port's sparse-path kernels as the profiler names them (each
# template instantiation is a row of its own)
PATH_KERNEL_NAMES = {"edge_rounds": "edge_rounds_kernel<",
                     "edge_rounds_bucketed": "edge_rounds_bucketed_kernel<",
                     "simplex_project": "simplex_project"}


def path_launch_ms(torch, core, net, phi0, nbrs, bks, bucketed,
                   n_iters=3) -> dict:
    """Device ms a launch of each port kernel on the path's own (warm)
    inputs: one traced run of `n_iters` iterations, every instantiation
    of a kernel summed."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        core.run(net, phi0, n_iters=n_iters, bucketed=bucketed, nbrs=nbrs,
                 buckets=bks if bucketed else None)
        torch.cuda.synchronize()
    out = {}
    for k, tag in PATH_KERNEL_NAMES.items():
        rows = [(e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and tag in e.key]
        n = sum(c for _, c in rows)
        if n:
            out[k] = {"ms": sum(t for t, _ in rows) / 1e3 / n, "launches": n}
    return out


def bisection_halvings(torch, ref, phi, delta, M, perm, n_iter=60,
                       weight=None):
    """Halvings the rows of this input need: each row counts until its
    own bracket stops moving (the oracle's loop, row by row).  Returns
    (halvings summed over rows, the same weighted by `weight` [R])."""
    q, w, _, lo, hi = ref.dual_setup(phi, delta, M, perm)
    live = torch.ones_like(lo, dtype=torch.bool)
    wt = (torch.ones_like(lo, dtype=torch.float64) if weight is None
          else weight.double().reshape(lo.shape))
    total = torch.zeros((), dtype=torch.float64, device=phi.device)
    work = torch.zeros((), dtype=torch.float64, device=phi.device)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        up = torch.clamp_min(q - mid * w, 0.0).sum(-1, keepdim=True) > 1.0
        lo2, hi2 = torch.where(up, mid, lo), torch.where(up, hi, mid)
        total += live.sum()
        work += (live * wt).sum()
        live = live & ((lo2 != lo) | (hi2 != hi))
        lo, hi = lo2, hi2
        if not bool(live.any()):
            break
    return float(total), float(work)


def record_path_operands(torch, core, ops, net, nbrs, bks, bucketed):
    """The operands of every K1, K2 and K3 call of one iteration of
    `core.run` (its initial flow solves included), copied as the wrappers
    receive them: {"edge_rounds" | "edge_rounds_bucketed" |
    "simplex_project": [all arguments, defaults filled in]}."""
    rec = {"edge_rounds": [], "edge_rounds_bucketed": [],
           "simplex_project": []}
    real = {k: getattr(ops, f"{k}_cuda") for k in rec}

    def recorder(kind):
        sig = inspect.signature(real[kind])

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            rec[kind].append(tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in bound.arguments.values()))
            return real[kind](*args, **kwargs)
        return call

    for k in rec:
        setattr(ops, f"{k}_cuda", recorder(k))
    try:
        core.run(net, core.spt_phi_sparse(net, nbrs), n_iters=1,
                 bucketed=bucketed, nbrs=nbrs,
                 buckets=bks if bucketed else None)
        torch.cuda.synchronize()
    finally:
        for k, fn in real.items():
            setattr(ops, f"{k}_cuda", fn)
    return rec


def ptxas_summary(report: str) -> dict:
    """Most registers of any kernel of one source, and its spill lines,
    each after the (mangled) name of the function it is about."""
    regs = [int(w) for ln in report.splitlines() if "registers" in ln
            for w, nxt in zip(ln.split(), ln.split()[1:])
            if nxt.startswith("registers") and w.isdigit()]
    spills, fn = [], ""
    for ln in report.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif "spill" in ln and not ln.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads"):
            spills.append(f"{fn}: {ln.strip()}")
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spills": spills[:8]}


def allclose(torch, got, want, tol: float):
    """(max abs error, whether |got - want| <= tol + tol·|want| holds)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= tol + tol * want.float().abs()).all())


def attention_kernel_checks(torch, emit_kernel):
    """K4 and K5 against their plain versions at the serving shapes, in
    float32 and bfloat16, with PyTorch's SDPA timed on the same inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    hd = 128
    # Qwen3-0.6B's prefill (16 heads over 8 KV heads) at four lengths,
    # then OLMoE's (16 over 16, group size 1) at three
    shapes = [(1, 16, 8, L, "qwen3") for L in (17, 128, 333, 512)]
    shapes += [(1, 16, 16, L, "olmoe") for L in (17, 333, 512)]
    for dt in (torch.float32, torch.bfloat16):
        for B, H, KV, L, model in shapes:
            # the model's [B, L, heads, hd] activations, transposed views
            q = randn(B, L, H, hd, dt=dt).transpose(1, 2)
            k = randn(B, L, KV, hd, dt=dt).transpose(1, 2)
            v = randn(B, L, KV, hd, dt=dt).transpose(1, 2)
            out = flash_attention_cuda(q, k, v, causal=True)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal=True)
            err, ok = allclose(torch, out, want, tol[dt])
            require(ok, f"K4 {model} L={L} {dt}: max abs err {err} beyond "
                    f"{tol[dt]}")
            lib_err = allclose(torch, sdpa(q, k, v, is_causal=True,
                                           enable_gqa=True), want, tol[dt])[0]
            calls = (lambda: flash_attention_cuda(q, k, v, True),
                     lambda: ref.flash_attention_ref(q, k, v, True),
                     lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
            ms, plain, lib_ms = (device_ms(torch, fn, 20) for fn in calls)
            ev_ms, ev_plain, ev_lib = (time_ms(torch, fn, 20)
                                       for fn in calls)
            n_bytes = (2 * B * H + 2 * B * KV) * L * hd * q.element_size()
            n_ops = 4.0 * B * H * hd * L * (L + 1) / 2
            bms, by = bound_ms(n_bytes, n_ops, peak[dt])
            emit({"phase": "kernel", "kernel": "flash_attention",
                  "case": f"{model} prefill L={L} causal", "dtype": str(dt),
                  "q": [B, H, L, hd], "kv": [B, KV, L, hd],
                  "max_abs_err": err, "tol": tol[dt], "ms": ms,
                  "plain_ms": plain, "sdpa_ms": lib_ms,
                  "sdpa_ratio": ms / lib_ms,
                  "event_ms": [ev_ms, ev_plain, ev_lib],
                  "sdpa_max_abs_err": lib_err, "bound_ms": bms,
                  "bound_by": by})
            emit_kernel("flash_attention", max_abs_err=err,
                        main=(L == 512 and dt == torch.bfloat16
                              and model == "qwen3"), ms=ms,
                        plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms)

    # the other head dims and the non-causal form (not on the path): the
    # tensor-core kernel at hd 64, the CUDA-core one for bf16 at hd 80
    for L, hd_x, causal in ((100, 64, False), (77, 80, True)):
        q = randn(1, 4, L, hd_x, dt=torch.bfloat16)
        k = randn(1, 2, L, hd_x, dt=torch.bfloat16)
        v = randn(1, 2, L, hd_x, dt=torch.bfloat16)
        out = flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, ok = allclose(torch, out, ref.flash_attention_ref(
            q, k, v, causal=causal), 2e-2)
        require(ok, f"K4 L={L} hd={hd_x}: max abs err {err} beyond 2e-2")
        emit({"phase": "kernel", "kernel": "flash_attention",
              "case": f"L={L} hd={hd_x} causal={causal}",
              "dtype": "torch.bfloat16", "max_abs_err": err})
        emit_kernel("flash_attention", max_abs_err=err)

    # Qwen3-0.6B's decode (8 KV heads, group 2), then OLMoE's (16, 1):
    # ragged lengths from 1 to 1024 (the path's record), every length 1,
    # every length S, and a single request at S
    S = 1024
    len_cases = (("lengths 1..1024",
                  [1, 1024, 17, 512, 333, 1000, 64, 777]),
                 ("every length 1", [1] * 8),
                 ("every length 1024", [S] * 8),
                 ("B=1 length 1024", [S]))
    for dt, (KV, G, model), (label, lens) in itertools.product(
            (torch.float32, torch.bfloat16),
            ((8, 2, "qwen3"), (16, 1, "olmoe")), len_cases):
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n_pos = sum(lens)
        mask = (torch.arange(S, device="cuda")[None]
                < lengths[:, None])[:, None, None, :]
        q = randn(B, KV, G, hd, dt=dt)
        kc, vc = randn(B, S, KV, hd, dt=dt), randn(B, S, KV, hd, dt=dt)
        out = decode_attention_cuda(q, kc, vc, lengths)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, kc, vc, lengths)
        err, ok = allclose(torch, out, want, tol[dt])
        require(ok, f"K5 {model} {label} {dt}: max abs err {err} beyond "
                f"{tol[dt]}")
        qs = q.reshape(B, KV * G, 1, hd)
        ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)

        def lib():
            return sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        lib_err = allclose(torch, lib().reshape(B, KV, G, hd), want,
                           tol[dt])[0]
        calls = (lambda: decode_attention_cuda(q, kc, vc, lengths),
                 lambda: ref.decode_attention_ref(q, kc, vc, lengths), lib)
        ms, plain, lib_ms = (device_ms(torch, fn, 20) for fn in calls)
        ev_ms, ev_plain, ev_lib = (time_ms(torch, fn, 20) for fn in calls)
        elt = q.element_size()
        n_bytes = (2 * n_pos * KV * hd + 2 * B * KV * G * hd) * elt + 4 * B
        n_ops = 4.0 * hd * G * KV * n_pos
        bms, by = bound_ms(n_bytes, n_ops, peak[dt])
        emit({"phase": "kernel", "kernel": "decode_attention",
              "case": f"{model} decode B={B}, S={S}, {label}",
              "dtype": str(dt),
              "q": [B, KV, G, hd], "cache": [B, S, KV, hd],
              "positions": n_pos, "max_abs_err": err, "tol": tol[dt],
              "ms": ms, "plain_ms": plain, "sdpa_ms": lib_ms,
              "sdpa_ratio": ms / lib_ms,
              "event_ms": [ev_ms, ev_plain, ev_lib],
              "sdpa_max_abs_err": lib_err, "bound_ms": bms, "bound_by": by})
        emit_kernel("decode_attention", max_abs_err=err,
                    main=(dt == torch.bfloat16 and model == "qwen3"
                          and label == len_cases[0][0]), ms=ms,
                    plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)

    # K5 off the path: hd 50 is no multiple of a 16-byte vector (the
    # element-by-element loads) and G = 3 puts four query rows in a CTA
    for dt in (torch.float32, torch.bfloat16):
        lengths = torch.tensor([1, 64, 300], dtype=torch.int32,
                               device="cuda")
        q = randn(3, 2, 3, 50, dt=dt)
        kc, vc = randn(3, 300, 2, 50, dt=dt), randn(3, 300, 2, 50, dt=dt)
        out = decode_attention_cuda(q, kc, vc, lengths)
        torch.cuda.synchronize()
        err, ok = allclose(torch, out, ref.decode_attention_ref(
            q, kc, vc, lengths), tol[dt])
        require(ok, f"K5 hd=50 G=3 {dt}: max abs err {err} beyond "
                f"{tol[dt]}")
        emit({"phase": "kernel", "kernel": "decode_attention",
              "case": "B=3, S=300, hd=50, G=3, lengths 1, 64, 300",
              "dtype": str(dt), "max_abs_err": err})
        emit_kernel("decode_attention", max_abs_err=err)

    # K4 and K5 captured in one CUDA graph (their wrappers read no device
    # value on the host): replays on new inputs copied into the captured
    # tensors, new lengths too, hold against the plain versions
    B, L = 8, 333
    q, kc, vc = (randn(B, 8, 2, hd, dt=torch.bfloat16),
                 randn(B, S, 8, hd, dt=torch.bfloat16),
                 randn(B, S, 8, hd, dt=torch.bfloat16))
    lengths = torch.ones(B, dtype=torch.int32, device="cuda")
    qp, kp, vp = (randn(1, L, h, hd, dt=torch.bfloat16).transpose(1, 2)
                  for h in (16, 8, 8))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            decode_attention_cuda(q, kc, vc, lengths)
            flash_attention_cuda(qp, kp, vp, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        dec = decode_attention_cuda(q, kc, vc, lengths)
        pre = flash_attention_cuda(qp, kp, vp, True)
    errs = []
    for lens in ([1, 1024, 17, 512, 333, 1000, 64, 777], [S] * B):
        for t in (q, kc, vc, qp, kp, vp):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        for name, got, want in (
                ("decode_attention", dec,
                 ref.decode_attention_ref(q, kc, vc, lengths)),
                ("flash_attention", pre,
                 ref.flash_attention_ref(qp, kp, vp, True))):
            err, ok = allclose(torch, got, want, 2e-2)
            require(ok, f"{name} in a CUDA graph: max abs err {err} beyond "
                    "2e-2")
            errs.append(err)
            emit_kernel(name, max_abs_err=err)
    emit({"phase": "kernel", "kernel": "flash_attention+decode_attention",
          "case": "captured in one CUDA graph, two replays on new inputs",
          "dtype": "torch.bfloat16", "max_abs_err": max(errs)})
    del graph


def ssd_ops(B, L, H, P, N, Q=SSD_KERNEL_CHUNK) -> float:
    """Floating-point operations of the chunked SSD at chunk Q, as K6
    runs it: per chunk of q tokens the causal C·Bᵀ tile (q(q+1)/2·N
    multiply-adds, shared by the heads), the causal intra-chunk product
    (q(q+1)/2·H·P), the state read and the state update (q·N·H·P
    each); two operations a multiply-add."""
    total = 0.0
    for t0 in range(0, L, Q):
        q = min(Q, L - t0)
        tri = q * (q + 1) / 2
        total += tri * N + tri * H * P + 2.0 * q * N * H * P
    return 2.0 * B * total


def ssd_kernel_checks(torch, emit_kernel):
    """K6 against its plain version (the chunked SSD at chunk min(256, L))
    at the Mamba2-130M prefill's shapes, x [B, L, 24, 64], dt [B, L, 24],
    A [24], B/C [B, L, 128], in float32 and bfloat16: y and the final
    state.  Inputs as the model makes them: x, B and C through SiLU, dt
    through softplus, A = -exp(A_log) with A_log in [0, log 16]."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(2)
    silu = torch.nn.functional.silu
    # y: float32 sums of up to a few hundred terms taken in another order
    # (the kernel's chunk of 64 against the plain version's 256): 1e-4;
    # in bfloat16 y is rounded once on both sides and may land one ulp
    # apart (2^-8 relative): 1e-2.  The final state is float32 from the
    # same inputs in both dtypes: 1e-4.
    y_tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    s_tol = 1e-4
    H, P, N = 24, 64, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = [(1, L, dt, False) for dt in (torch.float32, torch.bfloat16)
             for L in (17, 128, 256, 512)]
    cases += [(4, 256, dt, False) for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 128, torch.float32, True)]      # with an initial state
    for B, L, dt_, with_init in cases:
        x = silu(randn(B, L, H, P)).to(dt_)
        Bm, Cm = silu(randn(B, L, N)).to(dt_), silu(randn(B, L, N)).to(dt_)
        dt = torch.nn.functional.softplus(randn(B, L, H) - 1.0)
        A = -torch.exp(torch.rand((H,), generator=gen, device="cuda")
                       * math.log(16.0))
        init = randn(B, H, N, P) if with_init else None
        y, state = ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=init)
        torch.cuda.synchronize()
        wy, ws = ref.ssd_scan_ref(x, dt, A, Bm, Cm, init_state=init)
        err_y, ok_y = allclose(torch, y, wy, y_tol[dt_])
        err_s, ok_s = allclose(torch, state, ws, s_tol)
        label = f"K6 B={B} L={L} {dt_}" + (" init" if with_init else "")
        require(y.dtype == dt_ and state.dtype == torch.float32,
                f"{label}: output dtypes {y.dtype}, {state.dtype}")
        require(ok_y, f"{label}: y max abs err {err_y} beyond {y_tol[dt_]}")
        require(ok_s, f"{label}: final state max abs err {err_s} beyond "
                f"{s_tol}")
        calls = (lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=init),
                 lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm,
                                          init_state=init))
        ms, plain = (device_ms(torch, fn, 10) for fn in calls)
        ev_ms, ev_plain = (time_ms(torch, fn, 10) for fn in calls)
        elt = x.element_size()
        n_bytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * elt \
            + 4 * (dt.numel() + H + state.numel()
                   + (init.numel() if with_init else 0))
        bms, by = bound_ms(n_bytes, ssd_ops(B, L, H, P, N))
        emit({"phase": "kernel", "kernel": "ssd_scan", "case": label,
              "x": [B, L, H, P], "N": N, "dtype": str(dt_),
              "max_abs_err": err_y, "tol": y_tol[dt_],
              "state_max_abs_err": err_s, "state_tol": s_tol,
              "max_abs_y": float(wy.float().abs().max()),
              "ms": ms, "plain_ms": plain, "event_ms": [ev_ms, ev_plain],
              "bound_ms": bms, "bound_by": by})
        emit_kernel("ssd_scan", max_abs_err=max(err_y, err_s),
                    main=(B == 1 and L == 512 and dt_ == torch.bfloat16),
                    ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                    library_ms=None)


def gmm_kernel_checks(torch, emit_kernel):
    """K7 against its plain version at OLMoE's expert products, x [64, C,
    2048] @ w [64, 2048, 1024] (wg, wu) and x [64, C, 1024] @ w [64,
    1024, 2048] (wd), C in {4, 52, 80} (the decode step's capacity and
    the prefill's at 333 and 512 tokens), plus two ragged shapes off the
    path (the second not 16-byte aligned: the CUDA-core kernel in
    bfloat16 too), in float32 (rtol 1e-5 of Σ_d |x·w|) and bfloat16 (one
    ulp, 2^-7), with torch.bmm timed on the same inputs as a yardstick
    (`bmm_ratio`).  At C = 4, as in a decode step, 40 of the 64 experts
    are also marked active with the others' rows zero: the kernel must
    equal its dense run bit for bit and the plain version to the same
    tolerance, and its time is put beside the dense one.  Last, one
    launch with `active` captured in a CUDA graph, replayed on new inputs
    and new active sets."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    gen = torch.Generator(device="cuda").manual_seed(3)
    # float32: sums of up to 2048 products in another order; rounding
    # works on the partial sums, so an output's error scales with
    # Σ_d |x·w| (the kernel and cuBLAS part by ~1e-4 where a sum of
    # magnitude ~1e3 cancels to near 0), and rtol 1e-5 is of that;
    # bfloat16: both sides round one float32 sum, at most one ulp (2^-7
    # of the value) apart
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
    peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}
    cases = [(64, C, D, F) for C in (4, 52, 80)
             for D, F in ((2048, 1024), (1024, 2048))]
    cases += [(3, 17, 200, 72), (2, 5, 37, 19)]
    for dt in (torch.float32, torch.bfloat16):
        for E, C, D, F in cases:
            x = torch.randn((E, C, D), generator=gen, device="cuda").to(dt)
            w = torch.randn((E, D, F), generator=gen, device="cuda").to(dt)
            out = moe_gmm_cuda(x, w)
            torch.cuda.synchronize()
            want = ref.moe_gmm_ref(x, w)
            if dt == torch.float32:
                d = (out - want).abs()
                err = float(d.max())
                ok = bool((d <= tol[dt] * ref.moe_gmm_ref(x.abs(),
                                                          w.abs())).all())
            else:
                err, ok = allclose(torch, out, want, tol[dt])
            label = f"K7 [{E},{C},{D}]@[{E},{D},{F}] {dt}"
            require(out.dtype == dt and out.shape == (E, C, F),
                    f"{label}: output {out.dtype} {tuple(out.shape)}")
            require(ok, f"{label}: max abs err {err} beyond {tol[dt]}")
            calls = (lambda: moe_gmm_cuda(x, w),
                     lambda: ref.moe_gmm_ref(x, w),
                     lambda: torch.bmm(x, w))
            ms, plain, lib_ms = (device_ms(torch, fn, 10) for fn in calls)
            elt = x.element_size()
            n_bytes = (E * C * D + E * D * F + E * C * F) * elt
            bms, by = bound_ms(n_bytes, 2.0 * E * C * D * F, peak[dt])
            emit({"phase": "kernel", "kernel": "moe_gmm", "case": label,
                  "x": [E, C, D], "w": [E, D, F], "dtype": str(dt),
                  "max_abs_err": err, "tol": tol[dt],
                  "max_abs_out": float(want.float().abs().max()),
                  "ms": ms, "plain_ms": plain, "bmm_ms": lib_ms,
                  "bmm_ratio": ms / lib_ms, "bound_ms": bms, "bound_by": by})
            emit_kernel("moe_gmm", max_abs_err=err,
                        main=(dt == torch.bfloat16 and C == 4 and D == 2048
                              and E == 64),
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms)
            if E == 64 and C == 4:
                gmm_active_case(torch, gen, x, w, dt, tol[dt], emit_kernel)
    gmm_graph_case(torch, gen, tol[torch.bfloat16], emit_kernel)


def gmm_active_case(torch, gen, x, w, dt, tol, emit_kernel, n_active=40):
    """K7 at a decode step's C = 4 with `n_active` of 64 experts holding
    rows (the others' rows zero) and `active` given: equal to the dense
    kernel on the same inputs, and to the plain version within `tol`;
    timed beside the dense kernel on the same inputs; the bound counts
    the active experts' bytes only."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    E, C, D = x.shape
    F = w.shape[-1]
    active = torch.zeros(E, dtype=torch.bool, device="cuda")
    active[torch.randperm(E, generator=gen, device="cuda")[:n_active]] = True
    xa = x * active[:, None, None].to(dt)
    got = moe_gmm_cuda(xa, w, active)
    dense = moe_gmm_cuda(xa, w)
    torch.cuda.synchronize()
    want = ref.moe_gmm_ref(xa, w, active)
    label = f"K7 [{E},{C},{D}]@[{E},{D},{F}] {dt}, {n_active} active"
    require(torch.equal(got, dense), f"{label}: != the dense kernel")
    if dt == torch.float32:
        d = (got - want).abs()
        err = float(d.max())
        ok = bool((d <= tol * ref.moe_gmm_ref(xa.abs(), w.abs())).all())
    else:
        err, ok = allclose(torch, got, want, tol)
    require(ok, f"{label}: max abs err {err} beyond {tol}")
    calls = (lambda: moe_gmm_cuda(xa, w, active),
             lambda: moe_gmm_cuda(xa, w),
             lambda: ref.moe_gmm_ref(xa, w, active),
             lambda: torch.bmm(xa, w))
    ms, dense_ms, plain, lib_ms = (device_ms(torch, fn, 10) for fn in calls)
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
    n_bytes = (n_active * (C * D + D * F) + E * C * F) * x.element_size()
    bms, by = bound_ms(n_bytes, 2.0 * n_active * C * D * F, peak)
    emit({"phase": "kernel", "kernel": "moe_gmm", "case": label,
          "x": [E, C, D], "w": [E, D, F], "dtype": str(dt),
          "active": n_active, "equal_to_dense": True, "max_abs_err": err,
          "tol": tol, "ms": ms, "dense_ms": dense_ms,
          "active_ratio": ms / dense_ms, "plain_ms": plain, "bmm_ms": lib_ms,
          "bmm_ratio": ms / lib_ms, "bound_ms": bms, "bound_by": by})
    emit_kernel("moe_gmm", max_abs_err=err)


def gmm_graph_case(torch, gen, tol, emit_kernel):
    """One bfloat16 K7 launch with `active` captured in a CUDA graph (the
    wrapper reads no device value on the host), replayed on new inputs
    and new active sets copied into the captured tensors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    E, C, D, F = 64, 4, 2048, 1024
    x = torch.zeros((E, C, D), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((E, D, F), dtype=torch.bfloat16, device="cuda")
    active = torch.ones(E, dtype=torch.bool, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            moe_gmm_cuda(x, w, active)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = moe_gmm_cuda(x, w, active)
    errs = []
    for n_active in (40, 17):
        act = torch.zeros(E, dtype=torch.bool, device="cuda")
        act[torch.randperm(E, generator=gen, device="cuda")[:n_active]] = True
        active.copy_(act)
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda")
                * act[:, None, None])
        w.copy_(torch.randn(w.shape, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        err, ok = allclose(torch, out, ref.moe_gmm_ref(x, w, active), tol)
        require(ok, f"moe_gmm in a CUDA graph ({n_active} active): max abs "
                f"err {err} beyond {tol}")
        require(bool((out[~act] == 0).all()), "moe_gmm in a CUDA graph: an "
                "inactive expert's output is not zero")
        errs.append(err)
        emit_kernel("moe_gmm", max_abs_err=err)
    emit({"phase": "kernel", "kernel": "moe_gmm",
          "case": "[64,4,2048]@[64,2048,1024] with active, captured in a "
                  "CUDA graph, two replays on new inputs and active sets",
          "dtype": "torch.bfloat16", "max_abs_err": max(errs)})
    del graph


def watch_tokens(eng, on_token, on_call=None) -> None:
    """Call `on_token(req, logits_row)` with the logits row behind every
    token `eng` (a `ServingEngine`) hands a request, prefill and decode,
    by wrapping its model's `prefill` and `decode_step` and its `admit`
    and `step`; the engine's own code is untouched.  `on_call()`, if
    given, runs right after each model call (a prefill or a decode
    step), before its tokens are handed out.  `del eng.admit, eng.step`
    undoes the last two."""
    model, last = eng.model, {}

    class Watched:
        def __getattr__(self, name):
            return getattr(model, name)

        def prefill(self, *args):
            out = model.prefill(*args)
            last["logits"] = out[0]
            if on_call is not None:
                on_call()
            return out

        def decode_step(self, *args):
            out = model.decode_step(*args)
            last["logits"] = out[0]
            if on_call is not None:
                on_call()
            return out

    eng.model = Watched()
    admit, step = eng.admit, eng.step

    def watched_admit(req):
        did = admit(req)
        if did:
            on_token(req, last["logits"][0])
        return did

    def watched_step():
        before = list(eng.active)
        did = step()
        if did:
            for i, req in enumerate(before):
                if req is not None:
                    on_token(req, last["logits"][i])
        return did

    eng.admit, eng.step = watched_admit, watched_step


def serve_run(torch, model, prompts, on_token=None, on_call=None):
    """The serving requests through a fresh engine: (requests, stats)
    with the launch counts of this run alone and host-clock times of
    each admission and decode step (each ends in a synchronize);
    `on_token` as in `watch_tokens`, called outside the timed calls,
    `on_call` inside them."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG))
    reqs = [Request(i, np.asarray(p, np.int32))
            for i, p in enumerate(prompts)]
    stats = {"prefill_ms": [], "decode_ms": []}
    admit, step = eng.admit, eng.step

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            did = fn(*args)
            torch.cuda.synchronize()
            if did:
                stats[key].append((time.perf_counter() - t0) * 1e3)
            return did
        return run

    eng.admit, eng.step = timed(admit, "prefill_ms"), timed(step,
                                                            "decode_ms")
    if on_token is not None:            # outside the timers
        watch_tokens(eng, on_token, on_call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats["base_gb"] = torch.cuda.memory_allocated() / 1e9
    ops.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    stats["seconds"] = time.perf_counter() - t0
    del eng.admit, eng.step     # the wrappers close over the engine
    stats["mstate"] = eng.mstate
    stats["launches"] = ops.launches()
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["tokens"] = sum(len(r.out) for r in reqs)
    return reqs, stats


def check_serve_run(reqs, stats, n_layers, label, per_prefill, per_decode):
    """Every request done with the length its budget and EOS dictate;
    n_layers times `per_prefill[k]` launches of each kernel k per prefill
    and `per_decode[k]` per decode step, and none of any other kernel."""
    eos, budget = SERVE_CONFIG["eos_id"], SERVE_CONFIG["max_new_tokens"]
    for r in reqs:
        require(r.done, f"{label}: request {r.rid} not done")
        cap = min(budget + 1, SERVE_CONFIG["max_len"] - len(r.prompt))
        if eos in r.out:
            require(r.out.index(eos) == len(r.out) - 1
                    and len(r.out) <= cap,
                    f"{label}: request {r.rid} runs past EOS")
        else:
            require(len(r.out) == cap, f"{label}: request {r.rid} has "
                    f"{len(r.out)} tokens, not {cap}")
    counts = stats["launches"]
    want = {k: n_layers * (len(stats["prefill_ms"]) * per_prefill.get(k, 0)
                           + len(stats["decode_ms"]) * per_decode.get(k, 0))
            for k in counts}
    require(counts == want, f"{label}: launches {counts} != {want}")


def serve_summary(stats) -> dict:
    pre, dec = stats["prefill_ms"], sorted(stats["decode_ms"])
    return {"requests": len(pre), "decode_steps": len(dec),
            "tokens": stats["tokens"], "seconds": stats["seconds"],
            "tokens_per_s": stats["tokens"] / stats["seconds"],
            "prefill_ms_mean": sum(pre) / len(pre),
            "prefill_ms": pre,
            "decode_ms_mean": sum(dec) / len(dec),
            "decode_ms_median": dec[len(dec) // 2],
            "peak_memory_gb": stats["peak_gb"],
            "allocated_before_gb": stats["base_gb"],
            "launches": stats["launches"]}


@contextlib.contextmanager
def reversed_keys(torch):
    """Within it the plain attention (`kernels.ref`, the `attn_impl="ref"`
    path) takes the keys and values in reverse order: the same function
    with its float32 sums taken in another order."""
    from repro_torch.kernels import ref

    def flash(q, k, v, causal=True):
        S, g = q.shape[2], q.shape[1] // k.shape[1]
        kf = k.float().flip(2).repeat_interleave(g, dim=1)
        vf = v.float().flip(2).repeat_interleave(g, dim=1)
        s = (q.float() @ kf.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if causal:
            keep = torch.ones((S, S), dtype=torch.bool,
                              device=q.device).tril().flip(-1)
            s = torch.where(keep, s, ref.NEG_INF)
        return ref._softmax_pv(s, vf).to(q.dtype)

    def decode(q, k_cache, v_cache, lengths):
        S, hd = k_cache.shape[1], k_cache.shape[-1]
        kf = k_cache.float().transpose(1, 2).flip(2)
        vf = v_cache.float().transpose(1, 2).flip(2)
        s = (q.float() @ kf.transpose(-1, -2)) * hd ** -0.5
        keep = (torch.arange(S, device=q.device)[None]
                < lengths[:, None]).flip(-1)
        s = torch.where(keep[:, None, None], s, ref.NEG_INF)
        return ref._softmax_pv(s, vf).to(q.dtype)

    saved = ref.flash_attention_ref, ref.decode_attention_ref
    ref.flash_attention_ref, ref.decode_attention_ref = flash, decode
    try:
        yield
    finally:
        ref.flash_attention_ref, ref.decode_attention_ref = saved


@contextlib.contextmanager
def sequential_ssd(torch):
    """Within it the plain SSD scan (`kernels.ref.ssd_scan_ref`, the
    `impl="ref"` path) is `ssd_sequential`, the token-by-token recurrence:
    the same function with its float32 sums taken in another order."""
    from repro_torch.kernels import ref
    from repro_torch.models.layers.ssd import ssd_sequential

    def scan(x, dt, A, Bm, Cm, init_state=None, chunk=256):
        return ssd_sequential(x, dt, A, Bm, Cm, init_state=init_state)

    saved = ref.ssd_scan_ref
    ref.ssd_scan_ref = scan
    try:
        yield
    finally:
        ref.ssd_scan_ref = saved


@contextlib.contextmanager
def reversed_sums(torch):
    """Within it the plain attention takes its keys in reverse order (as
    `reversed_keys`) and the plain grouped matmul (`kernels.ref.
    moe_gmm_ref`) its sums over D in reverse order: the MoE LM's plain
    versions with their float32 sums taken in another order."""
    from repro_torch.kernels import ref

    def gmm(x, w, active=None):
        out = torch.bmm(x.float().flip(-1), w.float().flip(1))
        if active is not None:
            out = torch.where(active.bool()[:, None, None], out, 0.0)
        return out.to(x.dtype)

    saved = ref.moe_gmm_ref
    ref.moe_gmm_ref = gmm
    try:
        with reversed_keys(torch):
            yield
    finally:
        ref.moe_gmm_ref = saved


def logit_gap(run, base) -> dict:
    """Max abs and relative L2 distance between two serving runs' logits
    rows, (requests, {(rid, step): row}), at every step they
    share: the prefill, then each decode step while both have handed
    the request the same tokens."""
    (reqs, rows), (b_reqs, b_rows) = run, base
    worst, num, den, n = 0.0, 0.0, 0.0, 0
    for r, b in zip(reqs, b_reqs):
        for t in range(min(len(r.out), len(b.out))):
            x, y = rows[(r.rid, t)], b_rows[(b.rid, t)]
            worst = max(worst, float((x - y).abs().max()))
            num += float(((x - y) ** 2).sum())
            den += float((y ** 2).sum())
            n += 1
            if r.out[t] != b.out[t]:
                break
    return {"max_abs": worst, "rel_l2": math.sqrt(num / den), "rows": n}


def one_ulp_shift(torch, model, golden) -> float:
    """The float32 witness: the largest relative change (against
    max(|logit|, 1)) of the prefill's logits at the golden's top-5
    indices when every entry of the embedding table moves by one ulp
    (times 1 + 2^-23), each prefill from the zero model state.  Printed
    beside the float32 serve's gap from the golden, whose rtol it shows
    the model's own sensitivity to."""
    from repro_torch.models import module
    saved = model.embed.detach().clone()
    worst = 0.0
    for r in golden["requests"]:
        prompt = torch.as_tensor([r["prompt"]], device=model.device)
        idx = torch.as_tensor(r["top5_indices"][0], device=model.device)
        rows = []
        for scale in (1.0, 1.0 + 2.0 ** -23):
            with torch.no_grad():
                model.embed.copy_(saved * scale)
            cache = module.zeros(model.init_cache_specs(1, prompt.shape[1]),
                                 model.device)
            state = module.zeros(model.state_specs(), model.device)
            rows.append(model.prefill(state, cache, prompt)[0][0,
                                                               idx].float())
        worst = max(worst, float(((rows[1] - rows[0]).abs()
                                  / rows[0].abs().clamp_min(1.0)).max()))
    with torch.no_grad():
        model.embed.copy_(saved)
    return worst


def serve_checks(torch, src, arch, golden_name, n_requests, witness,
                 per_prefill, per_decode):
    """A serving phase at `arch`'s full width: float32 against the JAX
    golden `golden_name`, then bfloat16 through the kernels, timed and
    counted, and through the plain versions and the `witness` (a context
    in which the plain versions take their float32 sums in another
    order).  Returns the launch counts of the bfloat16 kernel run and
    what --profile needs."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import build_model, module
    from repro_torch.models.lm import LM
    golden = load_golden(src, golden_name, arch, n_requests)
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    specs = LM(cfg, device="meta").param_specs()
    tree = module.init(specs, SERVE_SEED)
    emit({"phase": "serve_weights", "arch": arch,
          "params": module.param_count(specs),
          "seconds": time.perf_counter() - t0})
    prompts = [r["prompt"] for r in golden["requests"]]

    # float32, TF32 off, against the JAX engine's tokens and logits
    model = build_model(float32_config(torch, cfg))
    model.load_state_dict(lm_params_from_numpy(model.cfg, tree,
                                               model.device))
    gidx = {r["rid"]: r["top5_indices"] for r in golden["requests"]}
    seen, f32_first = {}, {}

    def gather(req, row):
        t = len(req.out) - 1
        if t == 0:
            f32_first[req.rid] = row.float().cpu()
        if t < len(gidx[req.rid]):
            idx = torch.as_tensor(gidx[req.rid][t], device=row.device)
            seen[(req.rid, t)] = row.float()[idx]

    label = f"{arch} float32 serve"
    reqs, stats = serve_run(torch, model, prompts, on_token=gather)
    check_serve_run(reqs, stats, cfg.n_layers, label, per_prefill,
                    per_decode)
    worst, worst_prefill, diverged = 0.0, 0.0, []
    for r, g in zip(reqs, golden["requests"]):
        for t, gtok in enumerate(g["tokens"]):
            require(t < len(r.out), f"{label}: request {r.rid} ended at "
                    f"{len(r.out)} tokens, the reference at "
                    f"{len(g['tokens'])}")
            rel, parted = top5_check(torch, label, r, g, t, seen)
            worst = max(worst, rel)
            worst_prefill = max(worst_prefill, rel if t == 0 else 0.0)
            if parted is not None:
                diverged.append(parted)
                break
        else:
            require(len(r.out) == len(g["tokens"]), f"{label}: request "
                    f"{r.rid} has {len(r.out)} tokens, the reference "
                    f"{len(g['tokens'])}")
    emit({"phase": "serve", "arch": arch, "dtype": "float32",
          "vs": golden_name, "max_rel_err_top5": worst,
          "max_rel_err_top5_prefill": worst_prefill,
          "diverged_at_near_ties": diverged,
          "one_ulp_embed_shift_top5": one_ulp_shift(torch, model, golden),
          **serve_summary(stats)})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # bfloat16, the production dtypes
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_numpy(cfg, tree, model.device))
    del tree
    counts = bf16_serve_checks(torch, model, prompts, witness, per_prefill,
                               per_decode, f32_first)
    return counts, (model, prompts)


def load_golden(src, golden_name, arch, n_requests) -> dict:
    with open(os.path.join(src, "repro_torch", "data", golden_name)) as f:
        golden = json.load(f)
    require(golden["arch"] == arch and golden["seed"] == SERVE_SEED
            and golden["serve"] == SERVE_CONFIG
            and len(golden["requests"]) == n_requests,
            f"{golden_name} names another configuration")
    return golden


def float32_config(torch, cfg):
    """cfg in float32 throughout, with TF32 off for every product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cfg.replace(compute_dtype=torch.float32,
                       cache_dtype=torch.float32)


def top5_check(torch, label, r, g, t, seen):
    """Step t of request r against its golden g: the logits at the
    golden's top-5 indices to rtol 1e-3 (of max(1, |logit|)), and the
    token equal unless the golden's top-2 margin is under that
    tolerance.  Returns (the relative error, a record of the parting or
    None)."""
    want = torch.tensor(g["top5_values"][t])
    got = seen[(r.rid, t)].cpu()
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    require(rel <= 1e-3, f"{label}: request {r.rid} step {t}: top-5 logits "
            f"off by rtol {rel}")
    if r.out[t] == g["tokens"][t]:
        return rel, None
    margin = g["top2_margin"][t]
    require(margin < 1e-3 * max(1.0, abs(want[0].item())),
            f"{label}: request {r.rid} step {t}: token {r.out[t]} != "
            f"{g['tokens'][t]} at top-2 margin {margin}")
    return rel, {"rid": r.rid, "step": t, "margin": margin}


def bf16_serve_checks(torch, model, prompts, witness, per_prefill,
                      per_decode, f32_first, forced=False) -> dict:
    """The bfloat16 serve: through the kernels, timed and counted; then,
    each logits row kept, through the kernels again, through the plain
    versions and through the witness, the kernels held to 1.5x the
    witness's distance from the plain run (`logit_gap`).  With `forced`
    (a model whose state is engine-global, as the MoE load EMAs) the
    three take the same inputs at every call instead (`forced_gaps`).
    Returns the launch counts of the timed run."""
    arch = model.cfg.name
    n_layers = model.cfg.n_layers
    label = f"{arch} bfloat16 serve"
    reqs, stats = serve_run(torch, model, prompts)
    check_serve_run(reqs, stats, n_layers, label, per_prefill, per_decode)
    emit({"phase": "serve", "arch": arch, "dtype": "bfloat16",
          "n_layers": n_layers, "kernels": "hopper", **serve_summary(stats)})
    runs = {}
    for name, impl, order in (
            ("kernels", None, contextlib.nullcontext()),
            ("plain", "ref", contextlib.nullcontext()),
            ("witness", "ref", witness(torch))):
        if forced and name != "kernels":
            continue
        rows = {}

        def keep(req, row, rows=rows):
            rows[(req.rid, len(req.out) - 1)] = row.float().cpu()

        model.impl = impl
        with order:
            r_reqs, r_stats = serve_run(torch, model, prompts, on_token=keep)
        require(all(r.done for r in r_reqs), f"{label}, {name} run: a "
                "request is not done")
        require(impl is None or not any(r_stats["launches"].values()),
                f"{label}: the {name} run launched a kernel")
        runs[name] = (r_reqs, rows)
    model.impl = None
    require([r.out for r in runs["kernels"][0]] == [r.out for r in reqs],
            f"{label}: two runs through the kernels differ")
    # bfloat16 rounds at every layer, and the layers carry any change of
    # float32 rounding into the logits: the kernels are held to what one
    # such change does to the plain versions, the witness's gap
    if forced:
        gaps = forced_gaps(torch, model, prompts, witness)
        record = {}
    else:
        gaps = {name: logit_gap(runs[name], runs["plain"])
                for name in ("kernels", "witness")}
        record = {
            "prefill_max_abs_vs_float32": {
                name: max(float((rows[(rid, 0)] - row).abs().max())
                          for rid, row in f32_first.items())
                for name, (_, rows) in runs.items()},
            "same_tokens_as_plain": {name: [a.out == b.out for a, b in zip(
                runs[name][0], runs["plain"][0])] for name in gaps}}
    emit({"phase": "serve", "arch": arch, "dtype": "bfloat16",
          "n_layers": n_layers, "vs_plain": gaps, "forced": forced,
          "kernels_within_2e-2": gaps["kernels"]["max_abs"] <= 2e-2,
          **record})
    for key in ("max_abs", "rel_l2"):
        require(gaps["kernels"][key] <= 1.5 * gaps["witness"][key],
                f"{label}: the kernels' logits are {key} "
                f"{gaps['kernels'][key]} from the plain versions', more "
                f"than 1.5x the witness's {gaps['witness'][key]}")
    return {k: stats["launches"][k] for k in {**per_prefill, **per_decode}}


def forced_gaps(torch, model, prompts, witness) -> dict:
    """The serving requests through the plain versions, which choose the
    tokens; at every call (a prefill or a decode step) the kernels and
    the witness take copies of the same model state, cache lanes,
    tokens and positions.  Returns `logit_gap`'s record of each against
    the plain logits over the rows of active requests at every call:
    with the state engine-global, a run of its own would carry every
    earlier call's routing into the later ones."""
    import numpy as np
    from repro_torch.models import module
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG))
    acc = {name: {"max_abs": 0.0, "num": 0.0, "den": 0.0, "rows": 0}
           for name in ("kernels", "witness")}

    def call(fn, state, cache, tokens, *rest):
        rows = ([0] if tokens.shape[0] == 1 else
                [i for i, r in enumerate(eng.active) if r is not None])
        outs = {}
        for name, impl, order in (
                ("kernels", None, contextlib.nullcontext()),
                ("witness", "ref", witness(torch))):
            model.impl = impl
            with order:
                outs[name] = getattr(model, fn)(
                    module.tree_map(torch.clone, state),
                    module.tree_map(torch.clone, cache), tokens,
                    *rest)[0][rows].float()
        model.impl = "ref"
        out = getattr(model, fn)(state, cache, tokens, *rest)
        base = out[0][rows].float()
        for name, got in outs.items():
            a = acc[name]
            a["max_abs"] = max(a["max_abs"], float((got - base).abs().max()))
            a["num"] += float(((got - base) ** 2).sum())
            a["den"] += float((base ** 2).sum())
            a["rows"] += len(rows)
        return out

    class Forced:
        def __getattr__(self, name):
            return getattr(model, name)

        def prefill(self, *args):
            return call("prefill", *args)

        def decode_step(self, *args):
            return call("decode_step", *args)

    eng.model = Forced()
    reqs = [Request(i, np.asarray(p, np.int32))
            for i, p in enumerate(prompts)]
    try:
        eng.run(reqs)
    finally:
        model.impl = None
    require(all(r.done for r in reqs), "the forced run: a request is not "
            "done")
    return {name: {"max_abs": a["max_abs"],
                   "rel_l2": math.sqrt(a["num"] / a["den"]),
                   "rows": a["rows"]} for name, a in acc.items()}


def olmoe_serve_checks(torch, src):
    """The OLMoE serving phases.  Float32 at full width and
    OLMOE_F32_LAYERS layers against the JAX golden, call by call in the
    engine's order, each call's logits at the golden's top-5 to rtol 1e-3
    and its tokens equal; the load EMAs are engine-global, so the first
    call that fails ends the comparison, and passes only at a routing
    near-tie (the call's smallest gap between a token's K-th and
    (K+1)-th selection logits under 1e-4 of max(1, |K-th|)) or at a
    top-2 near-tie of the golden's logits.  With no such call the final
    load EMAs hold to rtol 1e-5.  Then bfloat16 at full width and all 16
    layers, weights drawn on the card from SERVE_SEED (`module.draw`):
    per layer one K4 and three K7 per prefill, one K5 and three K7 per
    decode step, held to the witness (keys and D reversed)."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.serve import load_model
    from repro_torch.models import build_model, module
    from repro_torch.models.lm import LM
    golden_name = "reference_serve_olmoe.json"
    golden = load_golden(src, golden_name, OLMOE_ARCH, OLMOE_REQUESTS)
    cfg = configs.get_config(OLMOE_ARCH)
    cfg4 = cfg.replace(n_layers=OLMOE_F32_LAYERS)
    require(golden["config"] == {k: getattr(cfg4, k)
                                 for k in golden["config"]},
            f"{golden_name} names another configuration")
    per_prefill = {"flash_attention": 1, "moe_gmm": 3}
    per_decode = {"decode_attention": 1, "moe_gmm": 3}
    prompts = [r["prompt"] for r in golden["requests"]]

    t0 = time.perf_counter()
    specs = LM(cfg4, device="meta").param_specs()
    tree = module.init(specs, SERVE_SEED)
    model = build_model(float32_config(torch, cfg4))
    model.load_state_dict(lm_params_from_numpy(model.cfg, tree,
                                               model.device))
    del tree
    emit({"phase": "serve_weights", "arch": OLMOE_ARCH, "dtype": "float32",
          "n_layers": cfg4.n_layers, "params": module.param_count(specs),
          "seconds": time.perf_counter() - t0})
    gidx = {r["rid"]: r["top5_indices"] for r in golden["requests"]}
    seen, at_call, gaps = {}, {}, []

    def gather(req, row):
        t = len(req.out) - 1
        at_call[(req.rid, t)] = len(gaps) - 1
        if t < len(gidx[req.rid]):
            idx = torch.as_tensor(gidx[req.rid][t], device=row.device)
            seen[(req.rid, t)] = row.float()[idx]

    def router_gap():
        gaps.append(model.metrics["router_gap"])

    label = f"{OLMOE_ARCH} float32 serve ({cfg4.n_layers} layers)"
    reqs, stats = serve_run(torch, model, prompts, on_token=gather,
                            on_call=router_gap)
    check_serve_run(reqs, stats, cfg4.n_layers, label, per_prefill,
                    per_decode)
    gaps = [float(x) for x in gaps]
    by_call = {}
    for r, g in zip(reqs, golden["requests"]):
        for t, c in enumerate(g["calls"]):
            by_call.setdefault(c, []).append((r, g, t))
    worst, diverged = 0.0, []
    for c in range(golden["n_calls"]):
        try:
            parted = []
            for r, g, t in by_call[c]:
                require(at_call.get((r.rid, t)) == c, f"{label}: request "
                        f"{r.rid} step {t} is not in call {c}")
                rel, p = top5_check(torch, label, r, g, t, seen)
                worst = max(worst, rel)
                if p is not None:
                    parted.append(p)
            if parted:
                diverged.append({"call": c, "kind": "top-2 margin",
                                 "parted": parted})
                break
        except RuntimeError as err:
            require(gaps[c] < 1e-4, f"{err} (router gap {gaps[c]} at "
                    f"call {c})")
            diverged.append({"call": c, "kind": "routing",
                             "router_gap": gaps[c], "failure": str(err)})
            break
    ema_err = None
    if not diverged:
        require(len(gaps) == golden["n_calls"], f"{label}: {len(gaps)} "
                f"calls, the reference {golden['n_calls']}")
        want = torch.tensor(golden["final_load_ema"])
        got = stats["mstate"]["slot_00"]["load_ema"].float().cpu()
        ema_err = float(((got - want).abs()
                         / want.abs().clamp_min(1e-30)).max())
        require(ema_err <= 1e-5, f"{label}: final load EMAs off by rtol "
                f"{ema_err}")
    emit({"phase": "serve", "arch": OLMOE_ARCH, "dtype": "float32",
          "n_layers": cfg4.n_layers, "vs": golden_name,
          "max_rel_err_top5": worst, "calls": len(gaps),
          "diverged_at_near_ties": diverged,
          "final_load_ema_max_rel_err": ema_err,
          "min_router_gap": min(gaps),
          "one_ulp_embed_shift_top5": one_ulp_shift(torch, model, golden),
          **serve_summary(stats)})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = load_model(cfg, SERVE_SEED, draw="torch")
    torch.cuda.synchronize()
    emit({"phase": "serve_weights", "arch": OLMOE_ARCH, "dtype": "bfloat16",
          "n_layers": cfg.n_layers,
          "params": module.param_count(model.param_specs()),
          "draw": "torch.Generator on the card",
          "seconds": time.perf_counter() - t0,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    # (the float32 run has 4 layers: no prefill comparison with it)
    counts = bf16_serve_checks(torch, model, prompts, reversed_sums,
                               per_prefill, per_decode, {}, forced=True)
    return counts, (model, prompts)


def profile_decode(torch, model, prompts, label, top=12):
    """Device time by kernel over one traced bfloat16 serving run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats = serve_run(torch, model, prompts)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and e.key != "Activity Buffer Request"]
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    wall_ms = stats["seconds"] * 1e3
    emit({"phase": "profile", "scenario": label,
          "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms,
          "prefills": len(stats["prefill_ms"]),
          "decode_steps": len(stats["decode_ms"]),
          "launches": stats["launches"],
          "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                  for k, ms, n in rows[:top]],
          # the port's own kernels (csrc/), wherever they rank
          "port_kernels": [{"kernel": k[:80], "ms": ms, "calls": n}
                           for k, ms, n in rows
                           if k.split("(anonymous namespace)::", 1)[-1]
                           .startswith(PORT_KERNEL_PREFIXES)]})


if __name__ == "__main__":
    sys.exit(main())
