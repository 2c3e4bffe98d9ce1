#!/usr/bin/env python3
"""Where a bf16 serve's logits part from its plain versions, on one H100.

    python3 tools/serve_gaps.py [ARCH ...] [--profile]

For each architecture (default: whisper-base and qwen2-vl-7b) it draws
the bf16 model at full width on the card from `chip_smoke.SERVE_SEED`
(`load_model(draw="torch")`) and serves the requests of its golden
(`chip_smoke.py`'s serving settings) through the plain versions and
then through each variant, keeping every logits row.  Each variant's
distance from the plain run is `chip_smoke.logit_gap`'s (max abs and
relative L2 over the rows up to where the tokens part), with the
largest distance at the prefill beside it:

* `witness`: the plain attention with its keys reversed
  (`chip_smoke.reversed_keys`), the earlier serves' witness;
* `witness_dims`: keys and head dims reversed
  (`chip_smoke.reversed_orders`), the witness of the serves without
  qk-norm;
* `kernels`: K4 and K5; `k4_only`, `k5_only`: one kernel, the other's
  plain version;
* `p_two_parts`, `p_three_parts`: the plain prefill attention with its
  probabilities P carried as two or three bfloat16 parts into the
  product with V (K4 carries two), the rest float32.

With --profile it instead times one traced bf16 serve of each
architecture after an untraced one (`chip_smoke.profile_decode`: device
time by kernel and the device's busy share).  Run from the root of a
checkout; one JSON line a result.
"""
import contextlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = {"whisper-base": "reference_serve_whisper.json",
           "qwen2-vl-7b": "reference_serve_qwen2vl.json",
           "qwen3-0.6b": "reference_serve.json"}


def split_flash(torch, ref, parts):
    """`ref.flash_attention_ref` with P carried as `parts` bf16 parts."""
    def flash(q, k, v, causal=True):
        S, hd, g = q.shape[2], q.shape[3], q.shape[1] // k.shape[1]
        kf = k.float().repeat_interleave(g, dim=1)
        vf = v.float().repeat_interleave(g, dim=1)
        s = (q.float() @ kf.transpose(-1, -2)) * hd ** -0.5
        if causal:
            keep = torch.ones((S, S), dtype=torch.bool,
                              device=q.device).tril()
            s = torch.where(keep, s, ref.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        acc, rest = 0.0, p
        for _ in range(parts):
            piece = rest.to(torch.bfloat16).float()
            acc = acc + piece @ vf
            rest = rest - piece
        return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
    return flash


@contextlib.contextmanager
def patched(obj, name, fn):
    saved = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def plain_only(fn):
    """`fn` (an `ops` dispatcher) forced onto its plain version."""
    def call(*args, impl=None, **kw):
        return fn(*args, impl="ref", **kw)
    return call


def gaps(torch, cs, model, prompts):
    from repro_torch.kernels import ops, ref
    variants = {
        "plain": ("ref", contextlib.nullcontext),
        "witness": ("ref", lambda: cs.reversed_keys(torch)),
        "witness_dims": ("ref", lambda: cs.reversed_orders(torch)),
        "kernels": (None, contextlib.nullcontext),
        "k4_only": (None, lambda: patched(
            ops, "decode_attention", plain_only(ops.decode_attention))),
        "k5_only": (None, lambda: patched(
            ops, "flash_attention", plain_only(ops.flash_attention))),
        "p_two_parts": ("ref", lambda: patched(
            ref, "flash_attention_ref", split_flash(torch, ref, 2))),
        "p_three_parts": ("ref", lambda: patched(
            ref, "flash_attention_ref", split_flash(torch, ref, 3))),
    }
    runs = {}
    for name, (impl, context) in variants.items():
        rows = {}

        def keep(req, row, rows=rows):
            rows[(req.rid, len(req.out) - 1)] = row.float().cpu()
        model.impl = impl
        with context():
            reqs, _ = cs.serve_run(torch, model, prompts, on_token=keep)
        runs[name] = (reqs, rows)
    model.impl = None
    plain = runs.pop("plain")
    out = {}
    for name, run in runs.items():
        out[name] = cs.logit_gap(run, plain)
        out[name]["prefill_max_abs"] = max(
            float((run[1][(r.rid, 0)] - plain[1][(r.rid, 0)]).abs().max())
            for r in plain[0])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("serve_gaps: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import load_model
    archs = [a for a in sys.argv[1:] if not a.startswith("--")] \
        or ["whisper-base", "qwen2-vl-7b"]
    _build.build_all()
    src = os.path.join(HERE, "src")
    for arch in archs:
        golden = cs.load_golden(src, GOLDENS[arch], arch, 12)
        prompts = [r["prompt"] for r in golden["requests"]]
        model = load_model(configs.get_config(arch), cs.SERVE_SEED,
                           draw="torch")
        if "--profile" in sys.argv[1:]:
            cs.serve_run(torch, model, prompts)
            cs.profile_decode(torch, model, prompts,
                              label=f"serve {arch} bfloat16")
        else:
            cs.emit({"arch": arch, **gaps(torch, cs, model, prompts)})
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
