#!/usr/bin/env python3
"""A/B timing of the port's kernels' variants on one H100.

    python3 tools/kernel_ab.py [--variant SOURCE=path.cu ...]
                               [--split-max 32,64,128,256]
                               [--only flash_attention,decode_attention,
                                       moe_gmm,edge_rounds_bucketed]

Builds the port's `flash_attention` (K4), `decode_attention` (K5),
`moe_gmm` (K7) and `edge_rounds` (K1, K2) from
`src/repro_torch/kernels/csrc`, and each variant source (a `.cu` with
the same C interface, named by the source it stands in for) with the
same nvcc flags.  For every case of the kernel's path it times the
port's wrapper by profiler device time with the source's library and
with each variant's swapped in, in the order source, variants,
variants reversed, source:

* K4: Qwen3-0.6B's and OLMoE's bf16 causal prefill at L in {17, 128,
  333, 512}, beside PyTorch's scaled_dot_product_attention;
* K5: their bf16 decode at B = 8, S = 1024 with ragged lengths, every
  length 1024 and every length 1, and B = 1 at 1024, plus float32
  ragged, beside scaled_dot_product_attention; with --split-max also
  with the wrapper's split plan capped at each value;
* K7: OLMoE's expert products [64, C, 2048] @ [64, 2048, 1024] and
  [64, C, 1024] @ [64, 1024, 2048] at C in {4, 52, 80} in bf16, at C in
  {4, 80} in float32, and the decode's C = 4 with 40 of 64 experts
  active, beside torch.bmm;
* K2: ba_10000's cold traffic, marginals and taint-pair solves of
  `chip_smoke.py`, and the seven solves of the sparse main path's first
  iteration (recorded from `core.run`).

Each variant is checked against the plain version first (K2 bit for
bit; 2e-2 / one ulp in bf16, 2e-4 / rtol 1e-5 of Σ|x·w| in float32).
One JSON line a case.
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

PREFILL = [(16, 8, L, "qwen3") for L in (17, 128, 333, 512)]
PREFILL += [(16, 16, L, "olmoe") for L in (333, 512)]
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
        for fn, argtypes in build._SIGNATURES[kernel].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        out[(kernel, os.path.basename(path))] = lib
    return out


KERNELS = ("flash_attention", "decode_attention", "moe_gmm",
           "edge_rounds_bucketed")
SOURCE_OF = {"edge_rounds_bucketed": "edge_rounds"}


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
    sources = sorted({SOURCE_OF.get(k, k) for k in only})
    _build.build_all(sources)
    libs = {k: {"source": _build.load(k)} for k in sources}
    for (kernel, label), lib in build_variants(_build, args.variant).items():
        libs[kernel][label] = lib
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def ab(kernel, call, want, tol, check=None):
        """{label: [ms, ms]} in the order source, variants, reversed;
        `check(got)` -> (err, ok) replaces the allclose to `want`."""
        labels = list(libs[kernel])
        times = {}
        for label in labels + labels[::-1]:
            _build._LIBS[kernel] = libs[kernel][label]
            got = call()
            err, ok = (check(got) if check is not None
                       else cs.allclose(torch, got, want, tol))
            if not ok:
                raise RuntimeError(f"{kernel} {label}: max abs err {err}")
            times.setdefault(label, []).append(
                cs.device_ms(torch, call, 30))
        _build._LIBS[kernel] = libs[kernel]["source"]
        return times

    if {"flash_attention", "decode_attention"} & only:
        attention_ab(torch, cs, ref, dmod, decode_attention_cuda,
                     flash_attention_cuda, sdpa, randn, ab, only,
                     args.split_max)
    if "moe_gmm" in only:
        gmm_ab(torch, cs, ref, ab)
    if "edge_rounds_bucketed" in only:
        k2_ab(torch, cs, ref, ab)
    return 0


def attention_ab(torch, cs, ref, dmod, decode_attention_cuda,
                 flash_attention_cuda, sdpa, randn, ab, only, split_max):
    """K4 and K5 at their path shapes, beside SDPA."""
    for H, KV, L, model in PREFILL if "flash_attention" in only else ():
        q, k, v = (randn(1, L, h, 128, dt=torch.bfloat16).transpose(1, 2)
                   for h in (H, KV, KV))
        want = ref.flash_attention_ref(q, k, v, True)
        times = ab("flash_attention",
                   lambda: flash_attention_cuda(q, k, v, True), want, 2e-2)
        lib = cs.device_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                               enable_gqa=True), 30)
        print(json.dumps({"kernel": "flash_attention", "model": model,
                          "L": L, "ms": times, "sdpa_ms": lib}), flush=True)

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


def k2_ab(torch, cs, ref, ab):
    """K2 at ba_10000's cold solves and its main path's first-iteration
    solves (inputs recorded from `core.run`), checked bit for bit."""
    from repro_torch import core
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_rounds import edge_rounds_bucketed_cuda
    dev = torch.device("cuda")
    net = core.make_scenario(core.TABLE_II["ba_10000"], device=dev)
    nb, bk = core.build_neighbors(net.adj), core.build_buckets(net.adj)
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
    recorded = []

    def record(w, b, eb, reduce="sum", shift=0.0, max_rounds=None):
        recorded.append((w.clone(), b.clone(), eb, reduce, shift,
                         max_rounds))
        return edge_rounds_bucketed_cuda(w, b, eb, reduce, shift, max_rounds)
    ops.edge_rounds_bucketed_cuda = record
    try:
        core.run(net, core.spt_phi_sparse(net, nb), n_iters=1,
                 bucketed=True, nbrs=nb, buckets=bk)
    finally:
        ops.edge_rounds_bucketed_cuda = edge_rounds_bucketed_cuda
    cases += [(f"path call {i}", a) for i, a in enumerate(recorded)]
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


if __name__ == "__main__":
    sys.exit(main())
