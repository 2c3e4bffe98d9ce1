#!/usr/bin/env python3
"""A/B timing of the port's kernels' variants on one H100.

    python3 tools/kernel_ab.py [--variant SOURCE=path.cu ...]
                               [--split-max 32,64,128,256]
                               [--only flash_attention,flash_attention_bwd,
                                       decode_attention,
                                       moe_gmm,moe_gmm_bwd,edge_rounds,
                                       edge_rounds_bucketed,simplex_project,
                                       ssd_scan,main_path]

Builds the port's `flash_attention` (K4), `flash_attention_bwd` (K4's
backward), `decode_attention` (K5),
`moe_gmm` (K7), `moe_gmm_bwd` (K7's backward), `edge_rounds` (K1, K2),
`simplex_project` (K3) and
`ssd_scan` (K6) from `src/repro_torch/kernels/csrc`, and each variant
source (a `.cu` with the same C interface, named by the source it
stands in for; for `ssd_scan` also the serial-chunk kernel's interface,
`ssd_scan_launch` without scratch) with the same nvcc flags.  For every
case of the kernel's path it times the port's wrapper by profiler
device time with the source's library and with each variant's swapped
in, in the order source, variants, variants reversed, source:

* K4: Qwen3-0.6B's and OLMoE's bf16 causal prefill at L in {17, 128,
  333, 512}, Qwen2-VL-7B's at 512, whisper-base's encoder (1,500
  frames, non-causal), decoder (causal, 512) and cross attention (333
  rows against the 1,500 frames), beside PyTorch's
  scaled_dot_product_attention;
* K5: their bf16 decode at B = 8, S = 1024 with ragged lengths, every
  length 1024 and every length 1, and B = 1 at 1024, plus float32
  ragged, beside scaled_dot_product_attention; with --split-max also
  with the wrapper's split plan capped at each value;
* K4's backward: bfloat16 at `chip_smoke.K4_BWD_SHAPES` (Qwen3-0.6B's
  and Qwen2-VL-7B's training shapes, whisper-base's encoder, packed
  decoder and cross attention), each variant first held to 1.5x the
  witness's bfloat16 ulps, beside SDPA's backward alone;
* K7: OLMoE's expert products [64, C, 2048] @ [64, 2048, 1024] and
  [64, C, 1024] @ [64, 1024, 2048] at C in {4, 52, 80} in bf16, at C in
  {4, 80} in float32, and the decode's C = 4 with 40 of 64 experts
  active, beside torch.bmm;
* K7's backward: bfloat16 at `chip_smoke.K7_BWD_SHAPES` (OLMoE's wg/wu
  and wd products at C = 80, 40 of 64 experts active, and C = 640), in
  the order source, variants, the route before the backward kernel (two
  K7 launches on transposed copies, `transposed_bwd`, kept here only),
  and back, each first
  held to 1.5x the witness's bfloat16 ulps, beside two torch.bmm calls
  and the plain gradient, with the bound;
* K1: sw_1000's cold traffic, taint-pair and longest-path solves of
  `chip_smoke.py` and the seven solves of the sparse main path's first
  iteration (recorded from `core.run`);
* K2: ba_10000's cold traffic, marginals and taint-pair solves and the
  seven solves of its main path's first iteration;
* K3: the two QP calls of each main path's first iteration, the dense
  engine's first two at sw_1000 ([64,000, 1,001] and [64,000, 1,000])
  and at sw_queue ([12,000, 101] and [12,000, 100]), and ba_10000's data
  rows under a random 70 % mask;
* K6: Mamba2-130M's prefill scan (x [1, L, 24, 64], B/C [1, L, 128])
  at the 12 prompt lengths of its serve, in bf16 and float32, and the
  serve's sum over them (24 layers);
* main_path: `core.run` (host driver) for 20 iterations on sw_1000 and
  ba_10000, ms
  an iteration untraced (the median of three runs after a warm-up), with
  the sources' libraries, with each variant's alone, and with every
  variant's at once, in that order and reversed, PATH_ROUNDS times over
  (so each pair of neighbours alternates PATH_ROUNDS times); each run's
  costs held to the JAX golden by `chip_smoke.check_costs`.

Each variant is checked against the plain version first (K1 and K2 bit
for bit with equal rounds; K3 to 1e-5; 2e-2 / one ulp in bf16, 2e-4 /
rtol 1e-5 of Σ|x·w| in float32; K6 as `chip_smoke.py` holds it).  One
JSON line a case.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (H, KV, Lq, Lk, hd, causal, model)
PREFILL = [(16, 8, L, L, 128, True, "qwen3") for L in (17, 128, 333, 512)]
PREFILL += [(16, 16, L, L, 128, True, "olmoe") for L in (333, 512)]
PREFILL += [(28, 4, 512, 512, 128, True, "qwen2vl"),
            (8, 8, 1500, 1500, 64, False, "whisper encoder"),
            (8, 8, 512, 512, 64, True, "whisper decoder"),
            (8, 8, 333, 1500, 64, False, "whisper cross")]
RAGGED = [1, 1024, 17, 512, 333, 1000, 64, 777]
DECODE = [("bf16", 8, 2, "qwen3", "ragged", RAGGED),
          ("bf16", 8, 2, "qwen3", "every length 1024", [1024] * 8),
          ("bf16", 8, 2, "qwen3", "every length 1", [1] * 8),
          ("bf16", 8, 2, "qwen3", "B=1 length 1024", [1024]),
          ("bf16", 16, 1, "olmoe", "ragged", RAGGED),
          ("bf16", 16, 1, "olmoe", "every length 1024", [1024] * 8),
          ("bf16", 16, 1, "olmoe", "B=1 length 1024", [1024]),
          ("f32", 8, 2, "qwen3", "ragged", RAGGED),
          ("f32", 16, 1, "olmoe", "ragged", RAGGED)]


def build_variants(build, variants):
    """{(kernel, label): ctypes library} for each KERNEL=path.cu."""
    out, procs = {}, []
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    for spec in variants:
        kernel, path = spec.split("=", 1)
        so = os.path.join(build.BUILD_DIR, "variant-"
                          + os.path.basename(path).replace(".cu", ".so"))
        procs.append((kernel, path, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    import chip_smoke as cs
    for kernel, path, so, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{path}: nvcc exited {proc.returncode}\n"
                               f"{report}")
        print(json.dumps({"variant": path,
                          "ptxas": cs.ptxas_summary(report)}), flush=True)
        lib = ctypes.CDLL(so)
        if kernel == "ssd_scan" and not hasattr(lib,
                                                "ssd_scan_chunks_launch"):
            lib = SerialSSD(lib)
        else:
            for fn, argtypes in build._SIGNATURES[kernel].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        out[(kernel, os.path.basename(path))] = lib
    return out


class SerialSSD:
    """A K6 library with the earlier C interface (`ssd_scan_launch`: the
    chunks walked in series, no scratch) behind the current wrapper's
    call, whose scratch and head count it drops."""

    def __init__(self, lib):
        self.lib = lib
        lib.ssd_scan_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        lib.ssd_scan_launch.restype = ctypes.c_int

    def ssd_scan_chunks_launch(self, bf16, x, dt, A, Bm, Cm, init, y, fin,
                               states, prev, totals, B, L, H, P, N, heads,
                               stream):
        return self.lib.ssd_scan_launch(bf16, x, dt, A, Bm, Cm, init, y,
                                        fin, B, L, H, P, N, stream)


KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "moe_gmm", "moe_gmm_bwd", "edge_rounds", "edge_rounds_bucketed",
           "simplex_project", "ssd_scan", "main_path")
PATH_SOURCES = ("edge_rounds", "simplex_project")
SOURCE_OF = {"edge_rounds_bucketed": "edge_rounds"}
PATH_ROUNDS = 10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--split-max", default="")
    ap.add_argument("--only", default=",".join(KERNELS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sources = sorted({SOURCE_OF.get(k, k) for k in only
                      if k != "main_path"}
                     | (set(PATH_SOURCES) if "main_path" in only else set()))
    for name, report in _build.build_all(sources).items():
        print(json.dumps({"source": name,
                          "ptxas": cs.ptxas_summary(report)}), flush=True)
    libs = {k: {"source": _build.load(k)} for k in sources}
    for (kernel, label), lib in build_variants(_build, args.variant).items():
        libs[kernel][label] = lib
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def ab(kernel, call, want, tol, check=None, others=None):
        """{label: [ms, ms]} in the order source, variants, `others`
        ({label: a call in place of `call`}), reversed; `check(got)` ->
        (err, ok) replaces the allclose to `want`."""
        others = others or {}
        labels = list(libs[kernel]) + list(others)
        times = {}
        for label in labels + labels[::-1]:
            run = others.get(label, call)
            if label in libs[kernel]:
                _build._LIBS[kernel] = libs[kernel][label]
            got = run()
            err, ok = (check(got) if check is not None
                       else cs.allclose(torch, got, want, tol))
            if not ok:
                raise RuntimeError(f"{kernel} {label}: max abs err {err}")
            times.setdefault(label, []).append(
                cs.device_ms(torch, run, 30))
        _build._LIBS[kernel] = libs[kernel]["source"]
        return times

    if {"flash_attention", "decode_attention"} & only:
        attention_ab(torch, cs, ref, dmod, decode_attention_cuda,
                     flash_attention_cuda, sdpa, randn, ab, only,
                     args.split_max)
    if "flash_attention_bwd" in only:
        bwd_ab(torch, cs, ref, flash_attention_cuda, sdpa, randn, ab)
    if "moe_gmm" in only:
        gmm_ab(torch, cs, ref, ab)
    if "moe_gmm_bwd" in only:
        gmm_bwd_ab(torch, cs, ref, ab)
    if "edge_rounds" in only:
        k1_ab(torch, cs, ref, ab)
    if "edge_rounds_bucketed" in only:
        k2_ab(torch, cs, ref, ab)
    if "simplex_project" in only:
        k3_ab(torch, cs, ref, ab)
    if "ssd_scan" in only:
        ssd_ab(torch, cs, ref, ab)
    if "main_path" in only:
        path_ab(torch, cs, _build, libs)
    return 0


def attention_ab(torch, cs, ref, dmod, decode_attention_cuda,
                 flash_attention_cuda, sdpa, randn, ab, only, split_max):
    """K4 and K5 at their path shapes, beside SDPA."""
    for H, KV, Lq, Lk, hd, causal, model in (
            PREFILL if "flash_attention" in only else ()):
        q = randn(1, Lq, H, hd, dt=torch.bfloat16).transpose(1, 2)
        k, v = (randn(1, Lk, KV, hd, dt=torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        want = ref.flash_attention_ref(q, k, v, causal)
        times = ab("flash_attention",
                   lambda: flash_attention_cuda(q, k, v, causal), want,
                   2e-2)
        lib = cs.device_ms(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                               enable_gqa=True), 30)
        print(json.dumps({"kernel": "flash_attention", "model": model,
                          "L": Lq, "Lk": Lk, "hd": hd, "causal": causal,
                          "ms": times, "sdpa_ms": lib}), flush=True)

    S = 1024
    split_maxes = [int(x) for x in split_max.split(",") if x]
    for dtype, KV, G, model, label, lens in (
            DECODE if "decode_attention" in only else ()):
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = randn(B, KV, G, 128, dt=dt)
        kc, vc = randn(B, S, KV, 128, dt=dt), randn(B, S, KV, 128, dt=dt)
        want = ref.decode_attention_ref(q, kc, vc, lengths)

        def call():
            return decode_attention_cuda(q, kc, vc, lengths)
        tol = 2e-2 if dtype == "bf16" else 2e-4
        times = ab("decode_attention", call, want, tol)
        default = dmod.SPLIT_MAX
        for sm in split_maxes:
            dmod.SPLIT_MAX = sm
            times[f"source, split <= {sm}"] = [cs.device_ms(torch, call, 30)]
        dmod.SPLIT_MAX = default
        mask = (torch.arange(S, device="cuda")[None]
                < lengths[:, None])[:, None, None, :]
        qs = q.reshape(B, KV * G, 1, 128)
        lib = cs.device_ms(torch, lambda: sdpa(
            qs, kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
            enable_gqa=True), 30)
        print(json.dumps({"kernel": "decode_attention", "model": model,
                          "dtype": dtype, "case": label, "ms": times,
                          "sdpa_ms": lib}), flush=True)


def bwd_ab(torch, cs, ref, flash_attention_cuda, sdpa, randn, ab):
    """K4's backward in bfloat16 at `chip_smoke.K4_BWD_SHAPES`, each
    source and variant held first to 1.5x the witness's bfloat16 ulps
    (`chip_smoke.witness_check`'s rule), beside SDPA's backward alone on
    a retained graph (with the segments as a boolean mask)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    with cs.reversed_orders(torch):
        witness = ref.flash_attention_ref
    for B, H, KV, Lq, Lk, hd, causal, packed, case in cs.K4_BWD_SHAPES:
        dt = torch.bfloat16
        q, do = (randn(B, Lq, H, hd, dt=dt).transpose(1, 2)
                 for _ in range(2))
        k, v = (randn(B, Lk, KV, hd, dt=dt).transpose(1, 2)
                for _ in range(2))
        seg = cs.k4_bwd_segments(torch, B, Lq) if packed else None
        _, lse, o32 = flash_attention_cuda(q, k, v, causal, seg,
                                           return_lse=True)
        _, want = cs.grads_of(torch, lambda a, b, c: ref.flash_attention_ref(
            a, b, c, causal, seg), (q, k, v), do)
        _, wit = cs.grads_of(torch, lambda a, b, c: witness(
            a, b, c, causal, seg), (q, k, v), do)

        def check(got):
            ulps = [cs.bf16_ulps(torch, g, w) for g, w in zip(got, want)]
            lim = [1.5 * max(cs.bf16_ulps(torch, x, w), 1.0)
                   for x, w in zip(wit, want)]
            return ulps, all(u <= m for u, m in zip(ulps, lim))
        times = ab("flash_attention_bwd", lambda: flash_attention_bwd_cuda(
            do, q, k, v, o32, lse, causal, seg), None, None, check)
        mask = (None if seg is None else
                ref.attention_mask(Lq, causal, seg, q.device))
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        so = (sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
              if mask is not None else
              sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True))
        lib = cs.device_ms(torch, lambda: torch.autograd.grad(
            so, (qs, ks, vs), do, retain_graph=True), 10)
        print(json.dumps({"kernel": "flash_attention_bwd", "case": case,
                          "q": [B, H, Lq, hd], "kv": [B, KV, Lk, hd],
                          "ms": times, "sdpa_bwd_ms": lib}), flush=True)
        del so, q, k, v, do, want, wit
    torch.cuda.empty_cache()


def gmm_ab(torch, cs, ref, ab):
    """K7 at OLMoE's expert products, beside torch.bmm."""
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [(torch.bfloat16, C, D, F, None) for C in (4, 52, 80)
             for D, F in ((2048, 1024), (1024, 2048))]
    cases += [(torch.float32, C, 2048, 1024, None) for C in (4, 80)]
    cases += [(torch.bfloat16, 4, 2048, 1024, 40)]
    for dt, C, D, F, n_active in cases:
        x = torch.randn((64, C, D), generator=gen, device="cuda").to(dt)
        w = torch.randn((64, D, F), generator=gen, device="cuda").to(dt)
        active = None
        if n_active is not None:
            active = torch.zeros(64, dtype=torch.bool, device="cuda")
            active[torch.randperm(64, generator=gen, device="cuda")
                   [:n_active]] = True
            x = x * active[:, None, None].to(dt)
        want = ref.moe_gmm_ref(x, w, active)
        scale = ref.moe_gmm_ref(x.abs(), w.abs()).float()

        def check(got):
            d = (got.float() - want.float()).abs()
            if dt == torch.float32:
                return float(d.max()), bool((d <= 1e-5 * scale).all())
            return cs.allclose(torch, got, want, 2.0 ** -7)
        times = ab("moe_gmm", lambda: moe_gmm_cuda(x, w, active), want,
                   None, check)
        bmm = cs.device_ms(torch, lambda: torch.bmm(x, w), 30)
        print(json.dumps({"kernel": "moe_gmm", "dtype": str(dt),
                          "x": [64, C, D], "w": [64, D, F],
                          "active": n_active, "ms": times, "bmm_ms": bmm}),
              flush=True)


def transposed_bwd(dy, x, w, active):
    """K7's backward before it had a kernel of its own, kept here only to
    time against: two launches of the forward kernel on contiguous
    transposed copies, dx = K7(dy, wᵀ) and dw = K7(xᵀ, dy)."""
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    return (moe_gmm_cuda(dy, w.transpose(1, 2).contiguous(), active),
            moe_gmm_cuda(x.transpose(1, 2).contiguous(), dy, active))


def gmm_bwd_ab(torch, cs, ref, ab):
    """K7's backward in bfloat16 at `chip_smoke.K7_BWD_SHAPES`, the source
    (and variants) against `transposed_bwd`, each held first to 1.5x the
    witness's bfloat16 ulps (the plain gradient with D reversed in the
    forward, `chip_smoke.witness_check`'s rule), beside two torch.bmm
    calls (dy @ wᵀ, xᵀ @ dy) and the plain gradient (CUDA events)."""
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda
    gen = torch.Generator(device="cuda").manual_seed(9)
    E, dt = 64, torch.bfloat16

    def rev(x, w, active):
        out = torch.bmm(x.float().flip(-1), w.float().flip(1))
        return torch.where(active[:, None, None], out, 0.0).to(x.dtype)
    for C, D, F, n_active in cs.K7_BWD_SHAPES:
        x = torch.randn((E, C, D), generator=gen, device="cuda").to(dt)
        w = (torch.randn((E, D, F), generator=gen, device="cuda")
             * D ** -0.5).to(dt)
        dy = torch.randn((E, C, F), generator=gen, device="cuda").to(dt)
        active = torch.zeros(E, dtype=torch.bool, device="cuda")
        active[torch.randperm(E, generator=gen, device="cuda")
               [:n_active]] = True
        x = x * active[:, None, None].to(dt)

        def plain():
            return cs.grads_of(torch, lambda a, b: ref.moe_gmm_ref(
                a, b, active), (x, w), dy)[1]
        want = plain()
        wit = cs.grads_of(torch, lambda a, b: rev(a, b, active), (x, w),
                          dy)[1]

        def check(got):
            ulps = [cs.bf16_ulps(torch, g, p) for g, p in zip(got, want)]
            lim = [1.5 * max(cs.bf16_ulps(torch, v, p), 1.0)
                   for v, p in zip(wit, want)]
            return ulps, all(u <= m for u, m in zip(ulps, lim))
        times = ab("moe_gmm_bwd", lambda: moe_gmm_bwd_cuda(dy, x, w, active),
                   None, None, check,
                   {"two K7 launches": lambda: transposed_bwd(dy, x, w,
                                                              active)})
        bmm = cs.device_ms(torch, lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                           torch.bmm(x.transpose(1, 2), dy)),
                           30)
        bound, by = cs.bound_ms((C * F + 2 * (C * D + D * F)) * 2 * n_active,
                                4.0 * n_active * C * D * F,
                                cs.PEAK_BF16_FLOPS)
        print(json.dumps({"kernel": "moe_gmm_bwd", "x": [E, C, D],
                          "w": [E, D, F], "active": n_active, "ms": times,
                          "two_bmm_ms": bmm,
                          "plain_ms": cs.time_ms(torch, plain, 3),
                          "bound_ms": bound, "bound_by": by}), flush=True)
        del x, w, dy, want, wit
    torch.cuda.empty_cache()


def path_operands(torch, cs, name):
    """(net, Neighbors, NeighborBuckets, the recorded operands of the
    main path's first iteration) of one scenario, on the card."""
    from repro_torch import core
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    net = core.make_scenario(core.TABLE_II[name], device=dev)
    nb, bk = core.build_neighbors(net.adj), core.build_buckets(net.adj)
    rec = cs.record_path_operands(torch, core, ops, net, nb, bk,
                                  dict(cs.PATHS)[name])
    return net, nb, bk, rec


def k1_ab(torch, cs, ref, ab):
    """K1 at sw_1000's cold solves and its main path's first-iteration
    solves, checked bit for bit."""
    from repro_torch.kernels import edge_rounds as er
    net, nb, _, rec = path_operands(torch, cs, "sw_1000")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S, V = net.S, net.V
    i32, u8 = torch.int32, torch.uint8
    w_out = cs.substochastic(torch, gen, nb.out_mask, S, 0.9)
    sup = ((torch.rand((2 * S, V, nb.Dmax), generator=gen, device=dev)
            < 0.3) & nb.out_mask).to(torch.bfloat16)
    seeds = (torch.rand((2 * S, V), generator=gen, device=dev)
             < 0.02).to(torch.bfloat16)
    dag = nb.out_mask & (nb.out_nbr > torch.arange(V, device=dev)[:, None])
    tiles_in = (nb.in_nbr.to(i32), nb.in_mask.to(u8))
    tiles_out = (nb.out_nbr.to(i32), nb.out_mask.to(u8))
    cases = [("cold traffic", (w_out[:, nb.in_nbr, nb.in_slot], net.r,
                               *tiles_in, "sum", 0.0, V)),
             ("cold taint pair", (sup, seeds, *tiles_out, "max", 0.0, V)),
             ("cold longest path", (dag.float()[None].expand(
                 S, V, nb.Dmax).contiguous(), torch.zeros((S, V),
                                                          device=dev),
                 *tiles_out, "max", 1.0, V))]
    cases += [(f"path call {i}", a) for i, a in enumerate(rec["edge_rounds"])]
    for label, (w, b, nbr, mask, reduce, shift, max_rounds) in cases:
        want = ref.edge_rounds_ref(w, b, nbr.long(), mask.bool(), reduce,
                                   shift, max_rounds)

        def call():
            return er.edge_rounds_cuda(w, b, nbr, mask, reduce, shift,
                                       max_rounds)

        def check(got):
            return 0.0, bool(torch.equal(got[0], want[0])
                             and int(got[1].max()) == want[1])
        times = ab("edge_rounds", call, None, None, check)
        plan = er.k1_plan(w.shape[0], *nbr.shape)
        print(json.dumps({"kernel": "edge_rounds", "case": label,
                          "S": w.shape[0], "reduce": reduce,
                          "dtype": str(w.dtype), "rounds": want[1],
                          "cluster": plan.size, "slots": plan.slots,
                          "ms": times}), flush=True)


def k2_ab(torch, cs, ref, ab):
    """K2 at ba_10000's cold solves and its main path's first-iteration
    solves (inputs recorded from `core.run`), checked bit for bit."""
    from repro_torch.kernels.edge_rounds import edge_rounds_bucketed_cuda
    net, nb, bk, rec = path_operands(torch, cs, "ba_10000")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S, V = net.S, net.V
    w_out = cs.substochastic(torch, gen, nb.out_mask, S, 0.9)
    sup = ((torch.rand((2 * S, V, nb.Dmax), generator=gen, device=dev)
            < 0.3) & nb.out_mask).to(torch.bfloat16)
    seeds = (torch.rand((2 * S, V), generator=gen, device=dev)
             < 0.02).to(torch.bfloat16)
    cases = [("cold traffic", (w_out, net.r, bk.inn, "sum", 0.0, V)),
             ("cold marginals", (w_out, torch.rand((S, V), generator=gen,
                                                   device=dev), bk.out,
                                 "sum", 0.0, V)),
             ("cold taint pair", (sup, seeds, bk.out, "max", 0.0, V))]
    cases += [(f"path call {i}", a)
              for i, a in enumerate(rec["edge_rounds_bucketed"])]
    for label, (w, b, eb, reduce, shift, max_rounds) in cases:
        want, _ = ref.edge_rounds_bucketed_ref(w, b, eb, reduce, shift,
                                               max_rounds)

        def check(got):
            return 0.0, bool(torch.equal(got[0], want))
        times = ab("edge_rounds", lambda: edge_rounds_bucketed_cuda(
            w, b, eb, reduce, shift, max_rounds), want, None, check)
        print(json.dumps({"kernel": "edge_rounds_bucketed", "case": label,
                          "S": w.shape[0], "reduce": reduce,
                          "dtype": str(w.dtype), "ms": times}), flush=True)


def k3_ab(torch, cs, ref, ab):
    """K3 at both main paths' first-iteration QPs, the dense engine's
    (sw_1000, sw_queue) and ba_10000's rows under a random 70 % mask, to
    1e-5."""
    from repro_torch import core
    from repro_torch.kernels import ops
    from repro_torch.kernels import simplex_project as spm
    dev = torch.device("cuda")
    cases = []
    for name, _ in cs.PATHS:
        net, nb, _, rec = path_operands(torch, cs, name)
        cases += [(f"{name} path call {i}", a[:4])
                  for i, a in enumerate(rec["simplex_project"])]
    for name in cs.DENSE_K3_SCENARIOS:
        net = core.make_scenario(core.TABLE_II[name], device=dev)
        rec = cs.record_path_operands(torch, core, ops, net, None, None,
                                      False, method="dense")
        cases += [(f"{name} dense path call {i}", a[:4])
                  for i, a in enumerate(rec["simplex_project"])]
        del net, rec
    gen = torch.Generator(device=dev).manual_seed(1)
    R, K = 160000, 278
    phi = torch.rand((R, K), generator=gen, device=dev)
    phi = phi / phi.sum(-1, keepdim=True)
    perm = torch.rand((R, K), generator=gen, device=dev) < 0.7
    perm[::11] = False
    cases.append(("ba_10000 data rows, random 70 % mask", (
        phi, torch.rand((R, K), generator=gen, device=dev) * 3,
        torch.rand((R, K), generator=gen, device=dev) * 2 + 0.25, perm)))
    for label, args in cases:
        want = ref.simplex_project_ref(*args)

        def call():
            return spm.simplex_project_cuda(*args)

        def check(got):
            err = float((got - want).abs().max())
            return err, err <= 1e-5
        times = ab("simplex_project", call, want, None, check)
        print(json.dumps({"kernel": "simplex_project", "case": label,
                          "shape": list(args[0].shape),
                          "permitted": int(args[3].sum()),
                          "rows_per_warp": spm.rows_per_warp(
                              args[0].shape[1]),
                          "ms": times}), flush=True)


def ssd_ab(torch, cs, ref, ab):
    """K6 at the Mamba2 serve's prefill shapes, each case held to the
    plain version first (y 1e-2 bf16 / 1e-4 float32, state 1e-4)."""
    import math
    from repro_torch.kernels import ssd_scan as smod
    gen = torch.Generator(device="cuda").manual_seed(7)
    H, P, N = 24, 64, 128
    silu = torch.nn.functional.silu

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    with open(os.path.join(ROOT, "src", "repro_torch", "data",
                           "reference_serve_mamba2.json")) as f:
        prompts = [len(r["prompt"]) for r in json.load(f)["requests"]]
    for dt_ in (torch.bfloat16, torch.float32):
        bf16 = dt_ == torch.bfloat16
        tol = 1e-2 if bf16 else 1e-4
        serve = {}
        for L in sorted(set(prompts)):
            x = silu(randn(1, L, H, P)).to(dt_)
            Bm = silu(randn(1, L, N)).to(dt_)
            Cm = silu(randn(1, L, N)).to(dt_)
            dt = torch.nn.functional.softplus(randn(1, L, H) - 1.0)
            A = -torch.exp(torch.rand((H,), generator=gen, device="cuda")
                           * math.log(16.0))
            wy, ws = ref.ssd_scan_ref(x, dt, A, Bm, Cm)

            def call():
                return smod.ssd_scan_cuda(x, dt, A, Bm, Cm)

            def check(got):
                ey, oky = cs.allclose(torch, got[0], wy, tol)
                es, oks = cs.allclose(torch, got[1], ws, 1e-4)
                return max(ey, es), oky and oks
            times = ab("ssd_scan", call, None, None, check)
            serve[L] = times
            print(json.dumps({"kernel": "ssd_scan", "dtype": str(dt_),
                              "x": [1, L, H, P], "N": N,
                              "heads": smod.ssd_plan(1, L, H, P, N,
                                                     bf16).heads,
                              "ms": times}), flush=True)
        # each label's mean over the serve's 24 layers and 12 prompts
        print(json.dumps({"kernel": "ssd_scan", "dtype": str(dt_),
                          "serve_sum_ms": {label: 24 * sum(
                              sum(serve[L][label]) / len(serve[L][label])
                              for L in prompts)
                              for label in serve[512]}}), flush=True)


def path_ab(torch, cs, build, libs):
    """ms an iteration of both main paths with the path kernels' sources,
    each variant alone and every variant at once, in that order and then
    reversed, PATH_ROUNDS times; every run held to the golden costs."""
    import statistics
    import time
    from repro_torch import core
    dev = torch.device("cuda")
    golden = cs.golden_costs(os.path.join(ROOT, "src"))
    source = {k: libs[k]["source"] for k in PATH_SOURCES}
    configs = [("sources", source)]
    variants = [(k, label) for k in PATH_SOURCES for label in libs[k]
                if label != "source"]
    configs += [(label, {**source, k: libs[k][label]})
                for k, label in variants]
    if len(variants) > 1:
        configs.append(("every variant", {**source, **{
            k: libs[k][label] for k, label in variants}}))
    for name, bucketed in cs.PATHS:
        net = core.make_scenario(core.TABLE_II[name], device=dev)
        nb, bk = core.build_neighbors(net.adj), core.build_buckets(net.adj)
        phi0 = core.spt_phi_sparse(net, nb)
        times = {}
        for label, chosen in (configs + configs[::-1]) * (PATH_ROUNDS // 2):
            build._LIBS.update(chosen)
            runs = []
            for rep in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, hist = core.run(net, phi0, n_iters=cs.N_ITERS,
                                   method="sparse", bucketed=bucketed,
                                   nbrs=nb,
                                   buckets=bk if bucketed else None,
                                   driver="host")
                torch.cuda.synchronize()
                n_exec = len(hist["costs"]) - 1 + hist["n_rejected"]
                if rep:                      # the first run warms up
                    runs.append((time.perf_counter() - t0) * 1e3 / n_exec)
                cs.check_costs(f"{name} with {label}", hist, golden[name])
            times.setdefault(label, []).append(statistics.median(runs))
        build._LIBS.update(source)
        print(json.dumps({"main_path": name, "ms_per_iteration": times,
                          "median": {k: statistics.median(v)
                                     for k, v in times.items()}}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
