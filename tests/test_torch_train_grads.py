"""Gradients of the port's training loss against the JAX package's, on
the CPU at reduced configs (d 64, float32, one layer), from the same
numpy weights (`models.module.init`, the JAX layout tree, which is also
the port's train-state layout) and the same packed batches
(`data.packed_batches`, documents of ~8 tokens so that every row holds
several segments):

* K4's plain version (`kernels.ref.flash_attention_ref`) under autograd
  against `jax.grad` of the JAX `naive_attention`: packed segments with
  GQA, and non-causal with Sk != Sq (cross attention);
* `LM.loss` against `jax.grad(model.loss)`: dense Qwen3 with
  `segment_ids` under `remat="layer"` (`torch.utils.checkpoint`),
  OLMoE with `moe_ep_scatter` False and True (the MoE custom VJPs, a
  random load EMA steering the congestion bias), Qwen2-VL with
  `vis_embed` and distinct t / h / w M-RoPE positions;
* `EncDecLM.loss` on reduced whisper-base with `segment_ids`.

Tolerance: the loss to rtol 1e-6; each gradient leaf within 1e-5 of
its JAX norm in L2 (‖g − g_jax‖ ≤ 1e-5·‖g_jax‖) and each element within
1e-5 of the leaf's largest JAX magnitude, or, where more, within three
times the distance by which the JAX gradient itself moves when every
weight goes one ulp up (the witness: the models without qk-norm, the
VLM and whisper, amplify float32 rounding; their worst leaves part
from JAX by ~2e-5 of the norm, as their own witness does); the MoE
metrics and new load EMAs to rtol 1e-6.  A mamba config raises
NotImplementedError naming P13e.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.models.layers.attention import naive_attention as jnaive
from repro_torch import configs
from repro_torch.data import DataConfig, packed_batches
from repro_torch.kernels import ref
from repro_torch.models import build_model, module
from repro_torch.train import loss_and_grads

torch.set_num_threads(1)

B, S = 2, 32
GRAD_RTOL = 1e-5


def _batch(cfg, seed):
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed,
                    mean_doc_len=8)
    return next(packed_batches(dc))


def _state(model, seed):
    rng = np.random.RandomState(seed)
    return module.tree_map(lambda s: rng.uniform(0.0, 5.0, s.shape).astype(
        np.float32), model.state_specs())


def _close_tree(got, want, what, witness=None):
    """Each leaf of `got` (tensors) against `want` (the JAX package's):
    within GRAD_RTOL of the leaf's norm in L2 and of its largest
    magnitude elementwise, or, where more, within 3x the distance of
    `witness` (the JAX run on inputs one ulp up) from `want`."""
    for path, w in module.leaves(want):
        g, wit = got, witness
        for k in path:
            g = g[k]
            wit = None if wit is None else wit[k]
        g, w = g.detach().numpy(), np.asarray(w)
        d_l2 = 0.0 if wit is None else float(np.linalg.norm(
            np.asarray(wit) - w))
        d_max = 0.0 if wit is None else float(np.abs(
            np.asarray(wit) - w).max())
        tol_l2 = max(GRAD_RTOL * float(np.linalg.norm(w)), 3 * d_l2, 1e-30)
        err = float(np.linalg.norm(g - w))
        assert err <= tol_l2, (what, path, err, tol_l2)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=max(GRAD_RTOL * float(np.abs(w).max()),
                                   3 * d_max, 1e-30),
            err_msg=f"{what} {path}")


def jit_o0(fn, *args):
    """fn jitted and compiled for `args` at XLA's backend optimisation
    level 0 (the same arithmetic, half the compile time on one core)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def one_ulp_up(tree):
    """Every floating leaf of a numpy tree moved one ulp towards +inf."""
    return module.tree_map(
        lambda a: np.nextafter(a, np.inf).astype(a.dtype)
        if np.issubdtype(a.dtype, np.floating) else a, tree)


def _run_pair(arch, seed, extra=None, **overrides):
    cfg = configs.get_reduced(arch, **overrides)
    jcfg = jconfigs.get_reduced(arch, **overrides)
    model = build_model(cfg, device="meta")
    jmodel = jbuild(jcfg)
    tree = module.init(model.param_specs(), seed)
    st = _state(model, seed)
    batch = _batch(cfg, seed)
    batch.update(extra(cfg) if extra else {})

    def jloss(p, s, b):
        loss, new_s, mets = jmodel.loss(p, s, b)
        return loss, (new_s, mets)

    jf = jit_o0(jax.value_and_grad(jloss, has_aux=True), tree, st, batch)
    (jl, (jst, jmets)), jg = jf(tree, st, batch)
    (_, _), jg_ulp = jf(one_ulp_up(tree), st, batch)
    t = module.tree_map(torch.as_tensor, tree)
    loss, g, new_st, mets = loss_and_grads(
        model, t, module.tree_map(torch.as_tensor, st),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    _close_tree(g, jg, arch, jg_ulp)
    for name, v in jmets.items():
        np.testing.assert_allclose(float(mets[name]), float(v), rtol=1e-6,
                                   err_msg=name)
    for path, v in module.leaves(jst):
        got = new_st
        for k in path:
            got = got[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(v), rtol=1e-6)


@pytest.mark.parametrize("case", ["causal packed GQA", "cross"])
def test_attention_ref_grad_matches_reference(case):
    """`flash_attention_ref`'s gradient (the plain version of K4's
    backward) against jax.grad of the JAX naive attention: causal with
    packed segments and GQA (8 heads over 2), and non-causal with 10
    queries against 17 keys; the loss Σ out·cot with a random
    cotangent."""
    rng = np.random.RandomState(0)
    seg = np.repeat(np.array([[1, 1, 1, 2, 2, 3, 3, 3, 3, 4, 4, 5]]), 2, 1)
    seg = np.concatenate([seg, np.sort(rng.randint(1, 4, (1, 24)))])
    cases = {"causal packed GQA": (8, 2, 24, 24, True, seg.astype(np.int32)),
             "cross": (4, 4, 10, 17, False, None)}
    for H, KV, Lq, Lk, causal, sid in (cases[case],):
        q = rng.standard_normal((2, Lq, H, 16)).astype(np.float32)
        k = rng.standard_normal((2, Lk, KV, 16)).astype(np.float32)
        v = rng.standard_normal((2, Lk, KV, 16)).astype(np.float32)
        cot = rng.standard_normal((2, Lq, H, 16)).astype(np.float32)

        def jf(q, k, v):
            return jnp.sum(jnaive(q, k, v, causal, sid) * cot)
        jg = jit_o0(jax.grad(jf, argnums=(0, 1, 2)), q, k, v)(q, k, v)
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = ref.flash_attention_ref(
            tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
            causal, None if sid is None else torch.as_tensor(sid))
        (out.transpose(1, 2) * torch.as_tensor(cot)).sum().backward()
        for got, want in zip((tq, tk, tv), jg):
            _close_tree({"x": got.grad}, {"x": want}, f"attention {causal}")


def test_dense_lm_loss_grads_match_reference():
    """Qwen3 reduced, packed segments, each layer recomputed under
    `torch.utils.checkpoint` (remat="layer", as the full config)."""
    _run_pair("qwen3-0.6b", 3, remat="layer", n_layers=1)


@pytest.mark.parametrize("ep", [False, True])
def test_moe_lm_loss_grads_match_reference(ep):
    """OLMoE reduced (8 experts, top 2): the dispatch / combine custom
    VJPs, gather-only or (moe_ep_scatter) scatter-add in token space."""
    _run_pair("olmoe-1b-7b", 4, moe_ep_scatter=ep, n_layers=1)


def test_vlm_loss_grads_match_reference():
    """Qwen2-VL reduced: vis_embed added to the embeddings and M-RoPE on
    distinct temporal / height / width positions."""
    def extra(cfg):
        rng = np.random.RandomState(5)
        pos = np.stack([np.arange(S) // 4, np.arange(S) % 4,
                        (np.arange(S) * 3) % 7])[:, None].repeat(B, 1)
        return {"vis_embed": 0.02 * rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "positions": pos.astype(np.int32)}
    _run_pair("qwen2-vl-7b", 5, extra, n_layers=1)


def test_encdec_loss_grads_match_reference():
    """whisper-base reduced (1 + 1 layers, 24 frames, features 0.02·N(0,
    1) as the launcher draws them): the encoder, the
    decoder's segment-masked self attention and its cross attention."""
    def extra(cfg):
        rng = np.random.RandomState(6)
        return {"enc_feats": 0.02 * rng.standard_normal(
            (B, cfg.n_enc_frames, cfg.d_model)).astype(np.float32)}
    _run_pair("whisper-base", 6, extra, n_layers=1, n_enc_layers=1)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_mamba_loss_raises_naming_p13e(arch):
    cfg = configs.get_reduced(arch)
    model = build_model(cfg, device="meta")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    with pytest.raises(NotImplementedError, match="P13e"):
        model.loss({}, batch)
