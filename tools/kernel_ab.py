#!/usr/bin/env python3
"""A/B timing of the attention kernels' variants on one H100.

    python3 tools/kernel_ab.py [--variant KERNEL=path.cu ...]
                               [--split-max 32,64,128,256]

Builds the port's `flash_attention` (K4) and `decode_attention` (K5)
from `src/repro_torch/kernels/csrc`, and each variant source (a `.cu`
with the same C interface) with the same nvcc flags.  For every case
of the kernel's path (K4: Qwen3-0.6B's and OLMoE's bf16 causal prefill
at L in {17, 128, 333, 512}; K5: their bf16 decode at B = 8, S = 1024
with ragged lengths, every length 1024 and every length 1, and B = 1 at
1024, plus float32 ragged) it times the port's wrapper by profiler
device time with the source's library and with each variant's swapped
in, in the order source, variants, variants reversed, source, and
PyTorch's scaled_dot_product_attention on the same inputs.  With
--split-max it
also times K5 with the wrapper's split plan capped at each value.  Each
variant is checked against the plain version first (2e-2 in bf16,
2e-4 in float32).  One JSON line a case.
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
    for kernel, path, so, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{path}: nvcc exited {proc.returncode}\n"
                               f"{report}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in build._SIGNATURES[kernel].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        out[(kernel, os.path.basename(path))] = lib
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--split-max", default="")
    args = ap.parse_args()
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
    _build.build_all(("flash_attention", "decode_attention"))
    libs = {k: {"source": _build.load(k)}
            for k in ("flash_attention", "decode_attention")}
    for (kernel, label), lib in build_variants(_build, args.variant).items():
        libs[kernel][label] = lib
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def ab(kernel, call, want, tol):
        """{label: [ms, ms]} in the order source, variants, reversed."""
        labels = list(libs[kernel])
        times = {}
        for label in labels + labels[::-1]:
            _build._LIBS[kernel] = libs[kernel][label]
            err, ok = cs.allclose(torch, call(), want, tol)
            if not ok:
                raise RuntimeError(f"{kernel} {label}: max abs err {err}")
            times.setdefault(label, []).append(
                cs.device_ms(torch, call, 30))
        _build._LIBS[kernel] = libs[kernel]["source"]
        return times

    for H, KV, L, model in PREFILL:
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
    split_maxes = [int(x) for x in args.split_max.split(",") if x]
    for dtype, KV, G, model, label, lens in DECODE:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
