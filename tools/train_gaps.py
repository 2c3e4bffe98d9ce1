#!/usr/bin/env python3
"""Where a bfloat16 train step's first gradient parts from its plain
versions, on one H100.

    python3 tools/train_gaps.py [ARCH ...] [--plant N] [--float32] [--k4]

For each architecture (default whisper-base; also qwen3-0.6b and
olmoe-1b-7b, at `chip_smoke.py`'s train sizes) it draws the start of
`chip_smoke.py`'s bfloat16 train run (`chip_smoke.train_start`) and takes
step 1's loss and gradient (`train.loss_and_grads`) through the plain
versions, each witness (`chip_smoke.train_witnesses`), the kernels, and
the kernels with one planted fault: the dq of the N-th K4 backward call
of the step zeroed (default 0, the last layer's last attention).  With
--float32 the model computes in float32 (`chip_smoke.float32_config`)
from the same start.  It
prints one JSON line a result:

Beside these, the kernels one at a time: `k4_only` (K7 plain),
`k4_fwd_only` (K4's forward, its backward by the plain gradient, K7
plain) and, with MoE, `k7_only` (K4 plain).

* `variants`: each run's loss and gradient norm, and its distance from
  the plain run's in both, beside the verdicts of
  `chip_smoke.train_gap_rule` (loss and norm) and
  `chip_smoke.leaf_gap_rule` (leaf by leaf) on step 1;
* `leaves`: the gradient leaves that part most from the plain run's,
  each with its plain norm and every run's distance ‖g − g_plain‖;
* `scores`: each K4 call of the plain forward (encoder layers, then
  per decoder layer self and cross attention): the largest scaled score
  |q·k|/√hd, the mean of the rows' largest probability and the share of
  rows whose largest probability exceeds 0.99 (a saturated softmax turns
  rounding into flips).

With --k4 it first holds K4's bfloat16 training forward beside the
plain version's variants on random inputs at OLMoE's and Qwen3's train
shapes (`k4_forward_spread`).  Run from the root of a checkout.
"""
import contextlib
import os
import sys

from serve_gaps import patched, plain_only

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_LEAVES = 12


def planted(torch, fa, n):
    """Within it the n-th call of K4's backward under autograd returns
    dq zeroed."""
    saved = fa.FlashAttentionFn.backward
    calls = [0]

    def backward(ctx, do):
        grads = saved(ctx, do)
        calls[0] += 1
        if calls[0] - 1 == n:
            return (torch.zeros_like(grads[0]),) + tuple(grads[1:])
        return grads
    return patched(fa.FlashAttentionFn, "backward", staticmethod(backward))


def plain_backward(torch, ref):
    """`FlashAttentionFn.backward` by the plain version's gradient on
    the saved inputs: K4's forward kept, its backward kernel left out."""
    def backward(ctx, do):
        q, k, v, _, _, seg = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.flash_attention_ref(*ins, ctx.causal, seg)
            grads = torch.autograd.grad(out, ins, do)
        return (*grads, None, None)
    return staticmethod(backward)


@contextlib.contextmanager
def score_stats(torch, ref, rows):
    """Within it each call of the plain attention appends its score
    statistics to `rows`."""
    saved = ref.flash_attention_ref

    def flash(q, k, v, causal=True, segment_ids=None):
        g = q.shape[1] // k.shape[1]
        s = (q.float() @ k.float().repeat_interleave(g, dim=1)
             .transpose(-1, -2)) * q.shape[-1] ** -0.5
        keep = ref.attention_mask(q.shape[2], causal, segment_ids, q.device)
        if keep is not None:
            s = torch.where(keep, s, ref.NEG_INF)
        top = torch.softmax(s, dim=-1).amax(-1)
        rows.append({"q": list(q.shape), "kv_len": k.shape[2],
                     "causal": causal,
                     "max_abs_score": float(torch.where(
                         s > ref.NEG_INF, s.abs(), 0.0).max()),
                     "mean_top_p": float(top.mean()),
                     "share_top_p_above_0.99": float((top > 0.99).float()
                                                     .mean())})
        return saved(q, k, v, causal, segment_ids)
    ref.flash_attention_ref = flash
    try:
        yield
    finally:
        ref.flash_attention_ref = saved


def settings(cs, configs, arch):
    """chip_smoke's bfloat16 train run of `arch`: (config, batch, seq,
    MoE?)."""
    if arch == cs.TRAIN_MOE_ARCH:
        return (configs.get_config(arch).replace(
            n_layers=cs.TRAIN_MOE_LAYERS), cs.TRAIN_BF16_BATCH,
            cs.TRAIN_BF16_SEQ, True)
    if arch == cs.TRAIN_ENCDEC_ARCH:
        return (configs.get_config(arch), cs.TRAIN_BF16_BATCH,
                cs.TRAIN_ENCDEC_SEQ, False)
    return (configs.get_config(arch), cs.TRAIN_BF16_BATCH,
            cs.TRAIN_BF16_SEQ, False)


def gaps(torch, cs, arch, plant, float32=False):
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model
    cfg, batch, seq, moe = settings(cs, configs, arch)
    if float32:
        cfg = cs.float32_config(torch, cfg)
    _, state, batches = cs.train_start(torch, cfg, batch, seq, 1)
    b = batches[0]
    wits = cs.train_witnesses(torch, moe)
    variants = {"plain": ("ref", None)}
    variants.update({f"witness_{i}": ("ref", w) for i, w in enumerate(wits)})
    # the plain version at K4's precision of P (two bfloat16 parts)
    variants["plain_p2"] = ("ref", lambda: cs.split_p(torch, 2))
    variants["plain_p3"] = ("ref", lambda: cs.split_p(torch, 3))
    variants["kernels"] = (None, None)
    variants["kernels_planted"] = (None, lambda: planted(torch, fa, plant))
    # one kernel at a time: K4 forward and backward with K7 plain, K4's
    # forward alone, and with MoE K7 alone
    variants["k4_only"] = (None, lambda: patched(
        ops, "moe_gmm", plain_only(ops.moe_gmm)))

    @contextlib.contextmanager
    def k4_fwd_only():
        with patched(ops, "moe_gmm", plain_only(ops.moe_gmm)), patched(
                fa.FlashAttentionFn, "backward", plain_backward(torch, ref)):
            yield
    variants["k4_fwd_only"] = (None, k4_fwd_only)
    if moe:
        variants["k7_only"] = (None, lambda: patched(
            ops, "flash_attention", plain_only(ops.flash_attention)))
    runs = {name: cs.step1_grads(torch, cfg, impl, state, b,
                                 ctx() if ctx else None)
            for name, (impl, ctx) in variants.items()}
    stats = []
    with torch.no_grad(), score_stats(torch, ref, stats):
        build_model(cfg, device="meta", impl="ref").loss(
            state["model_state"], b,
            params=_module_params(cfg, state["params"]))
    plain = runs["plain"]
    wit_runs = [runs[f"witness_{i}"] for i in range(len(wits))]
    mets = {n: [{"loss": r[0], "grad_norm": cs.grad_norm(r[1])}]
            for n, r in runs.items()}
    out = {}
    for name, r in runs.items():
        got, lim, bad = cs.train_gap_rule(
            mets[name], mets["plain"],
            [mets[f"witness_{i}"] for i in range(len(wits))])
        leaf, leaf_bad = cs.leaf_gap_rule(r[1], plain[1],
                                          [w[1] for w in wit_runs])
        out[name] = {**mets[name][0], "loss_gap": got["loss"][0],
                     "grad_norm_gap": got["grad_norm"][0],
                     "step1_limit": {k: v[0] for k, v in lim.items()},
                     "fails_norm_rule": bad, "leaves": leaf,
                     "fails_leaf_rule": len(leaf_bad)}
    dist = {p: {n: float((r[1][p] - plain[1][p]).norm())
                for n, r in runs.items() if n != "plain"}
            for p in plain[1]}
    top = sorted(dist, key=lambda p: -max(dist[p].values()))[:TOP_LEAVES]
    cs.emit({"arch": arch, "dtype": str(cfg.compute_dtype),
             "variants": out, "planted_call": plant})
    cs.emit({"arch": arch, "leaves": [
        {"leaf": p, "plain_norm": float(plain[1][p].norm()),
         "distance": dist[p]} for p in top]})
    cs.emit({"arch": arch, "scores": stats})


def k4_forward_spread(torch, cs):
    """K4's bfloat16 training forward (`return_lse=True`) beside the
    plain version's variants on the same random inputs at the train
    shapes: for each, the share of outputs that differ from the plain
    version's, the mean and largest distance in bfloat16 ulps
    (`chip_smoke.bf16_ulps`'s unit, elementwise)."""
    from repro_torch.data import DataConfig, packed_batches
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(9)
    seg = torch.as_tensor(next(packed_batches(DataConfig(
        vocab=1000, seq_len=512, global_batch=8,
        seed=cs.TRAIN_SEED)))["segment_ids"], device="cuda")
    variants = {"witness_keys": lambda: cs.reversed_keys(torch),
                "witness_dims": lambda: cs.reversed_keys(torch, dims=True,
                                                         keys=False),
                "witness_both": lambda: cs.reversed_orders(torch),
                "plain_p2": lambda: cs.split_p(torch, 2),
                "plain_p3": lambda: cs.split_p(torch, 3)}
    for H, KV, label in ((16, 16, "olmoe"), (16, 8, "qwen3")):
        q = torch.randn((8, 512, H, 128), generator=gen,
                        device="cuda").bfloat16().transpose(1, 2)
        k, v = (torch.randn((8, 512, KV, 128), generator=gen,
                            device="cuda").bfloat16().transpose(1, 2)
                for _ in range(2))
        plain = ref.flash_attention_ref(q, k, v, True, seg)
        outs = {"kernel": flash_attention_cuda(q, k, v, True, seg,
                                               return_lse=True)[0]}
        for name, ctx in variants.items():
            with ctx():
                outs[name] = ref.flash_attention_ref(q, k, v, True, seg)
        p = plain.float().abs()
        ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(
            p, 2.0 ** -6 * float(p.max())))) - 7)
        row = {}
        for name, o in outs.items():
            d = (o.float() - plain.float()).abs() / ulp
            row[name] = {"share_differing": float((d > 0).float().mean()),
                         "mean_ulps": float(d.mean()),
                         "max_ulps": float(d.max())}
        cs.emit({"k4_forward": label, "q": [8, H, 512, 128],
                 "kv_heads": KV, "variants": row})


def _module_params(cfg, params):
    """The JAX-layout masters as the model's parameter names, in the
    compute dtypes (as `loss_and_grads` feeds them)."""
    from repro_torch.convert import lm_params_from_tensors
    from repro_torch.models import build_model
    from repro_torch.train.step import model_dtypes
    dtypes = model_dtypes(build_model(cfg, device="meta"))
    sd = lm_params_from_tensors(cfg, params, check=False)
    return {k: t.to(dtypes[k]) for k, t in sd.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_gaps: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    args = sys.argv[1:]
    plant = 0
    if "--plant" in args:
        i = args.index("--plant")
        plant = int(args[i + 1])
        del args[i:i + 2]
    _build.build_all()
    if "--k4" in args:
        k4_forward_spread(torch, cs)
        args.remove("--k4")
        if not args:
            return 0
    float32 = "--float32" in args
    for arch in [a for a in args if a != "--float32"] \
            or [cs.TRAIN_ENCDEC_ARCH]:
        gaps(torch, cs, arch, plant, float32)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
