"""The port's MoE path against the JAX package's, at the reduced
olmoe-1b-7b config (2 layers, d 64, 4 heads over 2 KV heads, hd 16, 8
experts top-2 of d_ff 64, vocab 256, float32), on the same numpy inputs:

* K7's plain version `kernels.ref.moe_gmm_ref` against the JAX
  package's `moe_gmm_ref` and its Pallas kernel in interpret mode (f32
  rtol 1e-5, atol 1e-5 of the largest output; bf16 one ulp, 2^-7), and
  at a ragged C (200 rows) that only the port takes;
* `core.moe_bridge`'s six functions (f32 rtol 1e-6);
* the MoE layer (`models.layers.moe.moe`) with a nonzero load EMA, so
  the congestion bias steers the routing, and with drops: y, the new
  load EMA and both metrics (rtol = atol = 1e-5);
* `LM` prefill and decode with the model state threaded through, at
  reduced OLMoE and at reduced jamba cut to one period of 8 layers (the
  hybrid: Mamba2, attention, dense and MoE FFNs): logits, caches and the
  load EMAs (1e-5, or three times a one-ulp witness where the random
  hybrid amplifies float32 rounding past it);
* the engine's model-state lanes (a lane leaf is sliced to its slot, a
  global leaf replaced whole), and a reduced OLMoE engine run whose
  tokens, logits and final load EMAs equal the JAX engine's;
* the converter, the `torch.Generator` draw, `chip_smoke.py`'s gmm
  witness and the stored golden's form.

The JAX entry points are jitted at XLA's lowest backend optimisation
level (the same function, less compile time).  Run as a script, this
file writes the golden `chip_smoke.py` holds the card's float32 OLMoE
serve against:

    PYTHONPATH=src python tests/test_torch_moe.py --write-golden

the JAX `ServingEngine` on the CPU at full OLMoE width and 4 layers in
float32, the model state from `state_specs()`, weights from the port's
`models.module.init` (numpy) and seed 0, the 12 requests of
`chip_smoke.py`'s serving phases; it records each request's tokens and,
for every token, the top-5 logits, the top-2 margin and the engine call
that emitted it, and the final load EMAs.
"""
import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import moe_bridge as jbridge
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import LM as JLM
from repro.models import build_model as j_build_model
from repro.models import module as jmodule
from repro.models.layers import moe as jmoe
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.convert import (lm_leaf_dtypes, lm_params_from_numpy,
                                 lm_params_from_tensors, lm_state_from_numpy)
from repro_torch.core import moe_bridge
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import load_model, main as serve_main
from repro_torch.models import build_model, module
from repro_torch.models.layers import moe as moel
from repro_torch.serving import Request, ServeConfig, ServingEngine
from test_torch_serving import _chip_smoke, _record, golden_requests

torch.set_num_threads(1)

ARCH = "olmoe-1b-7b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_serve_olmoe.json")
TOL = dict(rtol=1e-5, atol=1e-5)
ULP_BF16 = 2.0 ** -7
SLOTS, MAX_LEN, PROMPT = 2, 24, 9

CFG = configs.get_reduced(ARCH)
JCFG = jconfigs.get_reduced(ARCH)
_OPT0 = {"xla_backend_optimization_level": 0}
# the JAX model and its entry points, jitted once for the shapes the LM
# and engine tests share: prompts of PROMPT tokens into one lane, decode
# over SLOTS lanes
JL = JLM(JCFG)
j_prefill = jax.jit(JL.prefill, compiler_options=_OPT0)
j_decode = jax.jit(JL.decode_step, compiler_options=_OPT0)


def _close(got, want, scaled=False, tol=TOL):
    want = np.asarray(want, np.float32)
    atol = tol["atol"] * (max(1.0, np.abs(want).max()) if scaled else 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=tol["rtol"], atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --------------------------------------------------------- K7 plain version
GMM_CASES = [(3, 8, 32, 16), (2, 16, 64, 48)]      # E, C, D, F
RAGGED = (2, 200, 24, 40)                           # C = 200: the port only


def _gmm_inputs(case, seed):
    E, C, D, F = case
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            rng.standard_normal((E, D, F)).astype(np.float32))


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@functools.cache
def _gmm_references():
    """The JAX package's moe_gmm_ref and Pallas kernel (interpret mode) at
    every GMM_CASES case in both dtypes, and its moe_gmm_ref at RAGGED,
    traced into one program."""
    args = {}
    for i, case in enumerate(GMM_CASES):
        x, w = _gmm_inputs(case, i)
        args[(case, "float32")] = (jnp.asarray(x), jnp.asarray(w))
        args[(case, "bfloat16")] = (_bf16(x), _bf16(w))
    x, w = _gmm_inputs(RAGGED, 9)
    args[(RAGGED, "float32")] = (jnp.asarray(x), jnp.asarray(w))
    args[(RAGGED, "bfloat16")] = (_bf16(x), _bf16(w))

    def run(a):
        return {k: (jref.moe_gmm_ref(x, w),
                    None if k[0] == RAGGED else
                    jops.moe_gmm(x, w, impl="pallas_interpret"))
                for k, (x, w) in a.items()}
    out = jax.jit(run, compiler_options=_OPT0)(args)
    return {k: tuple(None if o is None else np.asarray(o.astype(jnp.float32))
                     for o in v) for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES + [RAGGED])
def test_moe_gmm_ref_matches_reference(case, dtype):
    """f32: rtol 1e-5 with atol 1e-5 of the largest output (float32 sums
    of up to 64 products in another order); bf16: one ulp (both sides
    round one float32 sum once, so they part by at most one)."""
    seed = 9 if case == RAGGED else GMM_CASES.index(case)
    x, w = _gmm_inputs(case, seed)
    tdt = getattr(torch, dtype)
    got = ops.moe_gmm(_t(x).to(tdt), _t(w).to(tdt))
    assert got.dtype == tdt and got.shape == case[:2] + case[3:]
    tol = TOL if dtype == "float32" else dict(rtol=ULP_BF16, atol=ULP_BF16)
    want, pallas = _gmm_references()[(case, dtype)]
    _close(got.float(), want, scaled=True, tol=tol)
    if pallas is not None:
        _close(got.float(), pallas, scaled=True, tol=tol)
    exact = np.einsum("ecd,edf->ecf", _t(x).to(tdt).double().numpy(),
                      _t(w).to(tdt).double().numpy())
    _close(got.float(), exact, scaled=True, tol=tol)


@pytest.mark.parametrize("adtype", [torch.bool, torch.int32])
def test_moe_gmm_active_zeroes_the_empty_experts(adtype):
    """`active` sets the outputs of the experts it leaves out to zero and
    leaves the others equal to the dense product, bit for bit."""
    x, w = (_t(a) for a in _gmm_inputs((6, 5, 24, 16), 3))
    active = torch.tensor([1, 0, 1, 1, 0, 0]).to(adtype)
    dense = ops.moe_gmm(x, w, impl="ref")
    got = ops.moe_gmm(x, w, impl="ref", active=active)
    on = active.bool()
    assert torch.equal(got[on], dense[on])
    assert not got[~on].any() and dense[~on].abs().min() > 0
    assert torch.equal(ops.moe_gmm(x, w, impl="ref", active=None), dense)


@pytest.mark.parametrize("E,C,F,ctas", [(64, 4, 1024, 264), (64, 80, 2048, 264),
                                        (3, 200, 40, 5), (5, 7, 64, 132)])
def test_moe_gmm_schedule_covers_every_tile_once(E, C, F, ctas):
    """K7's persistent schedule deals each (expert, 128 rows, 64 or 128
    columns) tile of the active experts to exactly one CTA, CTAs
    differing by at most one tile; the inactive experts get none."""
    rng = np.random.RandomState(E + C)
    bn = gmm_mod.tile_width(C, tensor_cores=True)
    assert bn == (64 if C <= 16 else 128)
    assert gmm_mod.tile_width(C, tensor_cores=False) == 64
    for active in (None, rng.rand(E) < 0.6):
        plan = gmm_mod.tile_schedule(E, C, F, active, ctas, bn)
        assert len(plan) == ctas
        tiles = [t for cta in plan for t in cta]
        experts = [e for e in range(E) if active is None or active[e]]
        want = {(e, r, n) for e in experts for r in range(0, C, 128)
                for n in range(0, F, bn)}
        assert len(tiles) == len(want) and set(tiles) == want
        sizes = [len(cta) for cta in plan]
        assert max(sizes) - min(sizes) <= 1


# ------------------------------------------------------------ moe_bridge
E_BR = 6
_RNG = np.random.RandomState(11)
BR_LOAD = (_RNG.uniform(0.0, 14.0, E_BR)).astype(np.float32)
BR_CAP = (_RNG.uniform(8.0, 12.0, E_BR)).astype(np.float32)
BR_LINK = (_RNG.uniform(9.0, 15.0, E_BR)).astype(np.float32)
BR_W = (_RNG.uniform(0.5, 2.0, E_BR)).astype(np.float32)
BR_IDX = _RNG.randint(0, E_BR, (5, 7, 2)).astype(np.int32)


@functools.cache
def _bridge_references():
    def run(load, cap, link, w, idx):
        st = jbridge.CongestionState(load, jnp.asarray(3, jnp.int32))
        counts = jbridge.expert_counts(idx, E_BR)
        up = jbridge.update_state(st, counts)
        init = jbridge.init_state(E_BR)
        return {
            "init_state": (init.load_ema, init.step),
            "congestion_bias": (
                jbridge.congestion_bias(st, cap),
                jbridge.congestion_bias(st, cap, eta=0.7, a=0.5, w=w,
                                        link_capacity=link)),
            "update_state": (up.load_ema, up.step,
                             jbridge.update_state(st, counts,
                                                  decay=0.9).load_ema),
            "expert_counts": (counts,),
            "load_imbalance": (jbridge.load_imbalance(counts),
                               jbridge.load_imbalance(jnp.ones(E_BR))),
            "CongestionState": (st.load_ema, st.step)}
    out = jax.jit(run)(BR_LOAD, BR_CAP, BR_LINK, BR_W, BR_IDX)
    return {k: tuple(np.asarray(o) for o in v) for k, v in out.items()}


def _bridge_port():
    load, cap, link, w = (_t(a) for a in (BR_LOAD, BR_CAP, BR_LINK, BR_W))
    st = moe_bridge.CongestionState(load, torch.tensor(3, dtype=torch.int32))
    counts = moe_bridge.expert_counts(torch.from_numpy(BR_IDX), E_BR)
    up = moe_bridge.update_state(st, counts)
    init = moe_bridge.init_state(E_BR)
    return {
        "init_state": (init.load_ema, init.step),
        "congestion_bias": (
            moe_bridge.congestion_bias(st, cap),
            moe_bridge.congestion_bias(st, cap, eta=0.7, a=0.5, w=w,
                                       link_capacity=link)),
        "update_state": (up.load_ema, up.step,
                         moe_bridge.update_state(st, counts,
                                                 decay=0.9).load_ema),
        "expert_counts": (counts,),
        "load_imbalance": (moe_bridge.load_imbalance(counts),
                           moe_bridge.load_imbalance(torch.ones(E_BR))),
        "CongestionState": (st.load_ema, st.step)}


@pytest.mark.parametrize("name", ["init_state", "congestion_bias",
                                  "update_state", "expert_counts",
                                  "load_imbalance", "CongestionState"])
def test_moe_bridge_matches_reference(name):
    """Loads past SAT·cap included (the queue family's quadratic
    continuation); f32 rtol 1e-6, counts and steps exact."""
    for got, want in zip(_bridge_port()[name], _bridge_references()[name]):
        assert tuple(got.shape) == want.shape
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


# ------------------------------------------------------------- the layer
LAYER_CASES = [(1, 40, 1), (8, 1, 1), (2, 20, 2)]    # B, L, moe_groups


def _layer_inputs(B, L, groups):
    """Layer weights from the numpy init, x ~ N(0, 1), and a load EMA
    from 0 to 1.2x the bias's capacity T·K/E·1.3 (half the experts past
    SAT·cap: the bias outweighs the logits there)."""
    cfg = CFG.replace(moe_groups=groups)
    params = module.init(moel.moe_specs(cfg), 3)
    rng = np.random.RandomState(B * 100 + L)
    x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    cap = B * L * cfg.top_k / cfg.n_experts * 1.3
    ema = (rng.permutation(cfg.n_experts) / (cfg.n_experts - 1)
           * 1.2 * cap).astype(np.float32)
    return cfg, params, x, ema


def _tie_inputs():
    """A zero router and zero loads: every selection logit is equal."""
    params = {k: np.zeros(v.shape, np.float32) for k, v in
              module.init(moel.moe_specs(CFG), 0).items()}
    x = np.random.RandomState(0).standard_normal((1, 6, CFG.d_model))
    return params, x.astype(np.float32), np.zeros(CFG.n_experts, np.float32)


@functools.cache
def _layer_references():
    def one(params, x, ema, groups):
        jcfg = JCFG.replace(moe_groups=groups)
        return jmoe.moe(params, {"load_ema": ema}, x, jcfg)
    args = [_layer_inputs(*c)[1:] for c in LAYER_CASES] + [_tie_inputs()]
    groups = [c[2] for c in LAYER_CASES] + [1]
    out = jax.jit(lambda a: [one(p, x, e, g) for (p, x, e), g in
                             zip(a, groups)],
                  compiler_options=_OPT0)(args)
    return dict(zip(LAYER_CASES + ["ties"], out))


@pytest.mark.parametrize("case", LAYER_CASES)
def test_moe_layer_matches_reference(case):
    """y, the new load EMA, the imbalance and the drop share; drops are
    present (the dispatch's capacity rule is exercised)."""
    cfg, params, x, ema = _layer_inputs(*case)
    p = {k: _t(v) for k, v in params.items()}
    y, st, met = moel.moe(p, {"load_ema": _t(ema)}, _t(x), cfg)
    jy, jst, jmet = _layer_references()[case]
    _close(y, jy, scaled=True)
    _close(st["load_ema"], jst["load_ema"])
    for k in ("moe_imbalance", "moe_drop_frac"):
        _close(met[k], jmet[k])
    assert float(met["moe_drop_frac"]) > 0
    # the router gap: the K-th and (K+1)-th selection logits of the
    # closest token, over max(1, |K-th|)
    xt = x.reshape(-1, cfg.d_model).astype(np.float64)
    T = xt.shape[0]
    bias = moe_bridge.congestion_bias(
        moe_bridge.CongestionState(_t(ema), torch.zeros(())),
        torch.full((cfg.n_experts,), T * cfg.top_k / cfg.n_experts * 1.3),
        eta=cfg.router_bias_eta).double().numpy()
    sel = -np.sort(-(xt @ params["router"] + bias), axis=-1)
    K = cfg.top_k
    want = ((sel[:, K - 1] - sel[:, K])
            / np.maximum(np.abs(sel[:, K - 1]), 1.0)).min()
    assert abs(float(met["router_gap"]) - want) <= 1e-5


def test_topk_ties_take_the_lower_expert():
    """Equal selection logits go to the lower expert index, as
    `lax.top_k` orders them: with a zero router and zero loads every
    token picks experts 0..K-1, in the port as in the JAX layer."""
    params, x, ema = _tie_inputs()
    p = {k: _t(v) for k, v in params.items()}
    y, st, met = moel.moe(p, {"load_ema": _t(ema)}, _t(x), CFG)
    counts = (st["load_ema"] / 0.1).round()
    assert counts.tolist() == [6.0] * CFG.top_k + [0.0] * (
        CFG.n_experts - CFG.top_k)
    assert float(met["router_gap"]) == 0.0
    jy, jst, _ = _layer_references()["ties"]
    _close(st["load_ema"], jst["load_ema"])
    _close(y, jy)


# ---------------------------------------------------------------- the LM
@pytest.mark.parametrize("case", LAYER_CASES)
def test_moe_layer_active_experts_change_nothing(case, monkeypatch):
    """The layer's products told which experts hold a row give the same
    y, state and metrics, bit for bit, as the dense products: an expert
    with no assignment has only zero rows."""
    cfg, params, x, ema = _layer_inputs(*case)
    p = {k: _t(v) for k, v in params.items()}
    seen = []

    def dense(x, w, impl=None, active=None):
        seen.append(active)
        return ref.moe_gmm_ref(x, w)
    got = moel.moe(p, {"load_ema": _t(ema)}, _t(x), cfg)
    monkeypatch.setattr(moel.ops, "moe_gmm", dense)
    want = moel.moe(p, {"load_ema": _t(ema)}, _t(x), cfg)
    assert len(seen) == 3 and all(a is not None for a in seen)
    assert 0 < int(seen[0].sum()) <= cfg.n_experts
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]["load_ema"], want[1]["load_ema"])
    for k in got[2]:
        assert torch.equal(got[2][k], want[2][k])


@pytest.fixture(scope="module")
def pair():
    model = load_model(CFG, seed=1, device="cpu")
    tree = module.init(model.param_specs(), 1)
    return model, tree, jax.tree.map(jnp.asarray, tree)


def _j_zeros(jl, slots, max_len=MAX_LEN):
    return jax.tree.map(lambda s: jnp.asarray(np.zeros(s.shape, s.dtype)),
                        jl.init_cache_specs(slots, max_len),
                        is_leaf=lambda x: isinstance(x, jmodule.ParamSpec))


def _j_state(jl):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        jl.state_specs(),
                        is_leaf=lambda x: isinstance(x, jmodule.ParamSpec))


def _lm_run(model, jl, jp, prefill, decode, prompt_len, slots, steps,
            seed):
    """Prompts prefilled one lane at a time from the state the previous
    prefill left (as the engine admits), then decode steps over all
    lanes.  Returns the port's and the JAX LM's logits and load EMAs
    after every call, and their final caches."""
    cfg = model.cfg
    tc = module.zeros(model.init_cache_specs(slots, MAX_LEN), "cpu")
    ts = module.zeros(model.state_specs(), "cpu")
    js = _j_state(jl) if jl is not None else None
    rng = np.random.RandomState(seed)
    tout, jout, jlanes = [], [], []
    for slot in range(slots):
        p = rng.randint(2, cfg.vocab, (1, prompt_len))
        lane = module.tree_map(lambda c: c[:, slot:slot + 1], tc)
        tlog, ts, _ = model.prefill(ts, lane, torch.as_tensor(p))
        tout.append((tlog, ts))
        if jl is not None:
            jlog, js, jlane = prefill(jp, js, _j_zeros(jl, 1),
                                      jnp.asarray(p))
            jlanes.append(jlane)
            jout.append((jlog, js))
    jc = (jax.tree.map(lambda *c: jnp.asarray(np.concatenate(c, axis=1)),
                       *jlanes) if jl is not None else None)
    pos = np.full((slots,), prompt_len, np.int32)
    pos[-1] -= 3
    for _ in range(steps):
        tk = rng.randint(2, cfg.vocab, (slots, 1))
        tlog, ts, tc = model.decode_step(ts, tc, torch.as_tensor(tk),
                                         torch.as_tensor(pos))
        tout.append((tlog, ts))
        if jl is not None:
            jlog, js, jc = decode(jp, js, jc, jnp.asarray(tk),
                                  jnp.asarray(pos))
            jout.append((jlog, js))
        pos = pos + 1
    return tout, jout, tc, jc


def _ulp_shifted(model, fn):
    """fn() with every entry of the model's embedding table one ulp up
    (times 1 + 2^-23): the same function with its float32 rounding
    moved, whose distance from fn() bounds what rounding alone does."""
    saved = model.embed.detach().clone()
    with torch.no_grad():
        model.embed.mul_(1.0 + 2.0 ** -23)
    try:
        return fn()
    finally:
        with torch.no_grad():
            model.embed.copy_(saved)


def _witness_tol(got, shifted):
    """rtol 1e-5 with atol 1e-5, or three times the one-ulp witness's
    largest move where that is more."""
    return dict(rtol=1e-5, atol=max(1e-5, 3 * float(
        (shifted - got).abs().max())))


def _close_state(ts, js):
    assert set(ts) == set(js)
    for key in ts:
        _close(ts[key]["load_ema"], js[key]["load_ema"])


def _close_caches(tc, jc):
    for key, leaves in tc.items():
        for name, v in leaves.items():
            _close(v, jc[key][name], scaled=True)


def test_lm_prefill_and_decode_match_reference(pair):
    """Two prompts into two lanes, then three decode steps (lane 1 over
    the tail of its prompt): logits and load EMAs after every call, the
    final caches; the EMAs move and the layer metrics are set."""
    model, _, jp = pair
    tout, jout, tc, jc = _lm_run(model, JL, jp, j_prefill, j_decode, PROMPT,
                                 SLOTS, 3, 0)
    for (tlog, ts), (jlog, js) in zip(tout, jout):
        _close(tlog, jlog)
        _close_state(ts, js)
    _close_caches(tc, jc)
    assert float(ts["slot_00"]["load_ema"].abs().min()) > 0
    assert set(model.metrics) == {"moe_imbalance", "moe_drop_frac",
                                  "router_gap"}


def test_hybrid_jamba_matches_reference():
    """Reduced jamba (one period of 8 layers: Mamba2 and attention
    mixers, dense and MoE FFNs, four MoE slots of state) builds; one
    prompt of 16 tokens (the chunk) into each of
    two lanes and two decode steps agree with the JAX LM: the load EMAs
    to 1e-5 (the same routing), the logits to 1e-5 or, where more, to
    three times the port's own move under a one-ulp change of its
    embedding table (this random 16-layer hybrid turns float32 rounding
    into up to 7e-5 of logit), the caches to 1e-5 of their largest
    magnitude or three times the witness's move."""
    arch = "jamba-v0.1-52b"
    cfg = configs.get_reduced(arch, n_layers=8)
    jl = JLM(jconfigs.get_reduced(arch, n_layers=8))
    model = load_model(cfg, seed=2, device="cpu")
    jp = jax.tree.map(jnp.asarray, module.init(model.param_specs(), 2))
    args = (cfg.ssm_chunk, 2, 2, 4)
    tout, jout, tc, jc = _lm_run(
        model, jl, jp, jax.jit(jl.prefill, compiler_options=_OPT0),
        jax.jit(jl.decode_step, compiler_options=_OPT0), *args)
    shifted, _, wc, _ = _ulp_shifted(
        model, lambda: _lm_run(model, None, None, None, None, *args))
    for (tlog, ts), (jlog, js), (wlog, _) in zip(tout, jout, shifted):
        _close(tlog, jlog, tol=_witness_tol(tlog, wlog))
        _close_state(ts, js)
    for key, leaves in tc.items():
        for name, v in leaves.items():
            scale = max(1.0, float(v.abs().max()))
            tol = _witness_tol(v, wc[key][name])
            _close(v, jc[key][name], tol=dict(
                rtol=1e-5, atol=max(tol["atol"], 1e-5 * scale)))
    assert len(ts) == 4 and {m for m, _ in model.pattern} == {"attn",
                                                               "mamba"}


# ---------------------------------------------------- the engine's state
class StateTinyLM:
    """Serving stub of the JAX package's `tests/test_serving.py`: next
    token = (last + acc) % vocab, where `acc` is a per-slot accumulator
    kept in the model state under a "batch" axis (prefill sets it to
    Σprompt, decode adds the fed token)."""

    def __init__(self, slots: int, vocab: int = 13):
        self.slots, self.vocab = slots, vocab
        self.device = torch.device("cpu")

    def state_specs(self):
        return {"acc": module.ParamSpec((self.slots, 1), ("batch", "d"),
                                        torch.float32, "zeros")}

    def init_cache_specs(self, batch, max_len):
        return {}

    def _onehot(self, nxt):
        return torch.nn.functional.one_hot(nxt.long(), self.vocab).float()

    def prefill(self, state, cache, prompt):
        acc = prompt.sum(-1, keepdim=True).float()
        assert state["acc"].shape == acc.shape      # one lane
        nxt = (prompt[:, -1] + acc[:, 0].long()) % self.vocab
        return self._onehot(nxt), {"acc": acc}, cache

    def decode_step(self, state, cache, toks, pos):
        acc = state["acc"] + toks.float()
        nxt = (toks[:, 0] + acc[:, 0].long()) % self.vocab
        return self._onehot(nxt), {"acc": acc}, cache


def _req(rid, toks):
    return Request(rid=rid, prompt=np.asarray(toks, np.int32))


def _tiny(model, max_new=6, slots=2):
    return ServingEngine(model, ServeConfig(max_slots=slots, max_len=32,
                                            eos_id=99,
                                            max_new_tokens=max_new))


def test_admit_does_not_leak_state():
    """Admitting B mid-flight must not touch A's per-slot lane of the
    model state, so A's outputs match a solo run exactly."""
    pa, pb = [3, 4, 5], [9, 11]
    solo = _req(0, pa)
    _tiny(StateTinyLM(2)).run([solo], max_steps=50)
    eng = _tiny(StateTinyLM(2))
    a, b = _req(0, pa), _req(1, pb)
    assert eng.admit(a)
    eng.step()
    eng.step()
    assert eng.admit(b)                   # mid-flight admission
    eng.run([], max_steps=50)
    assert a.done and b.done
    assert a.out == solo.out


def test_global_state_leaves_stay_global():
    """A state leaf without a batch axis (a MoE-load-EMA-style
    accumulator) is engine-global: admission keeps the prefill-updated
    value whole, and the lane leaves keep their lane shape."""

    class GlobalLM(StateTinyLM):
        def state_specs(self):
            return {**super().state_specs(),
                    "n_prefills": module.ParamSpec((1,), ("d",),
                                                   torch.float32, "zeros")}

        def prefill(self, state, cache, prompt):
            logits, st, cache = super().prefill(
                {"acc": state["acc"]}, cache, prompt)
            st["n_prefills"] = state["n_prefills"] + 1.0
            return logits, st, cache

        def decode_step(self, state, cache, toks, pos):
            logits, st, cache = super().decode_step(
                {"acc": state["acc"]}, cache, toks, pos)
            st["n_prefills"] = state["n_prefills"]
            return logits, st, cache

    model = GlobalLM(slots=2)
    eng = ServingEngine(model, ServeConfig(max_slots=2, max_len=32,
                                           eos_id=99, max_new_tokens=2),
                        mstate=module.zeros(model.state_specs()))
    eng.run([_req(i, [2, 3]) for i in range(3)], max_steps=50)
    assert float(eng.mstate["n_prefills"][0]) == 3.0
    assert tuple(eng.mstate["acc"].shape) == (2, 1)


@pytest.fixture(scope="module")
def served(pair):
    """5 requests on 2 slots through both engines from zero load EMAs,
    same weights, prompts of PROMPT tokens; the JAX engine's prefill and
    decode are the jitted functions above."""
    model, _, jp = pair
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, CFG.vocab, size=PROMPT).astype(np.int32)
               for _ in range(5)]
    scfg = dict(max_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=6)
    tlog = []
    teng = ServingEngine(model, ServeConfig(**scfg))
    _chip_smoke().watch_tokens(teng, lambda r, row: tlog.append(
        (r.rid, row.numpy().copy())))
    treqs = [Request(i, p) for i, p in enumerate(prompts)]
    teng.run(treqs)

    def shifted_run():
        log = []
        eng = ServingEngine(model, ServeConfig(**scfg))
        _chip_smoke().watch_tokens(eng, lambda r, row: log.append(row))
        eng.run([Request(i, p) for i, p in enumerate(prompts)])
        return log
    wlog = _ulp_shifted(model, shifted_run)
    jeng = JServingEngine(JL, jp, JServeConfig(**scfg),
                          mstate=_j_state(JL))
    jlog = _record(jeng, prefill=j_prefill, decode=j_decode)
    jreqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    return teng, jeng, treqs, jreqs, tlog, jlog, wlog


def test_engine_matches_reference(served):
    """Tokens equal, the final load EMAs to 1e-5, every logits row to
    1e-5 or, where more, to three times the largest move of any row under
    a one-ulp change of the port's embedding table (the random reduced
    OLMoE turns float32 rounding into ~1e-5 of logit); the engine built
    its state from `state_specs()`."""
    teng, jeng, treqs, jreqs, tlog, jlog, wlog = served
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert [rid for rid, _ in tlog] == [rid for rid, _ in jlog]
    assert len(wlog) == len(tlog)
    moved = torch.stack([w - torch.from_numpy(t)
                         for (_, t), w in zip(tlog, wlog)])
    tol = _witness_tol(torch.zeros(()), moved.abs().max())
    for (_, t), (_, j) in zip(tlog, jlog):
        _close(t, j, tol=tol)
    _close_state(teng.mstate, jeng.mstate)
    assert teng._state_lane == {"slot_00": {"load_ema": -1}}


def test_serve_launcher_runs_on_cpu(capsys):
    assert serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "2", "--slots", "2", "--max-len",
                       "32"]) == 0
    assert "served 3 requests" in capsys.readouterr().out


# --------------------------------------------- converter and torch draw
def test_converter_carries_moe_leaves_and_state(pair):
    """ffn/router, wg, wu, wd carry over without reshapes, layer g of the
    stack is layer g; the state tree carries over whole; trees that do
    not match the model are refused."""
    model, tree, _ = pair
    sd = lm_params_from_numpy(CFG, tree, "cpu")
    ffn = tree["blocks"]["slot_00"]["ffn"]
    for g in range(CFG.n_layers):
        for name in ("router", "wg", "wu", "wd"):
            np.testing.assert_array_equal(sd[f"layers.{g}.{name}"].numpy(),
                                          ffn[name][g])
    state = module.init(model.state_specs(), 0)
    state["slot_00"]["load_ema"] += np.arange(
        CFG.n_experts, dtype=np.float32)
    got = lm_state_from_numpy(CFG, state, "cpu")
    np.testing.assert_array_equal(got["slot_00"]["load_ema"].numpy(),
                                  state["slot_00"]["load_ema"])
    with pytest.raises(ValueError):
        lm_state_from_numpy(CFG, {"slot_00": {"load_ema": np.zeros(3)}},
                            "cpu")
    bad = {**tree, "blocks": {"slot_00": dict(tree["blocks"]["slot_00"])}}
    bad["blocks"]["slot_00"]["ffn"] = {
        k: v for k, v in ffn.items() if k != "router"}
    with pytest.raises(ValueError):
        lm_params_from_numpy(CFG, bad, "cpu")


def test_torch_draw_rules_and_dtypes():
    """`module.draw`: each leaf in the dtype the model keeps it in,
    zeros and ones constant, normal and fan_in (over the stacked layer
    axis) at their std, the same generator seed the same tree; the state
    dict loads."""
    cfg = CFG.replace(compute_dtype=torch.bfloat16, d_model=256,
                      n_layers=4)
    model = build_model(cfg, device="cpu")
    specs = model.param_specs()
    draw = functools.partial(module.draw, specs, device="cpu",
                             dtype_of=lm_leaf_dtypes(model))
    tree = draw(torch.Generator().manual_seed(0))
    flat = dict(module.leaves(tree))
    assert [p for p, _ in module.leaves(specs)] == list(flat)
    ffn = ("blocks", "slot_00", "ffn")
    assert flat[ffn + ("wg",)].dtype == torch.bfloat16
    assert flat[ffn + ("router",)].dtype == torch.float32
    assert bool((flat[("final_norm",)] == 1).all())
    assert abs(float(flat[("embed",)].float().std()) - 0.02) < 1e-3
    wg = flat[ffn + ("wg",)].float()
    assert abs(float(wg.std()) * np.sqrt(cfg.n_layers) - 1.0) < 0.02
    again = dict(module.leaves(draw(torch.Generator().manual_seed(0))))
    assert all(torch.equal(again[k], v) for k, v in flat.items())
    model.load_state_dict(lm_params_from_tensors(cfg, tree))
    assert torch.equal(model.layers[3].wd, flat[ffn + ("wd",)][3])


# -------------------------------------------------- chip_smoke.py's parts
def test_chip_smoke_witness_is_the_plain_gmm():
    """The bfloat16 serve's witness takes the gmm's float32 sums over D
    in reverse order: the same function (f32: to rounding, 1e-5) within
    it, the plain version given back on exit; it also reverses the
    attention keys."""
    x, w = (_t(a) for a in _gmm_inputs((3, 7, 50, 9), 4))
    plain = (ref.moe_gmm_ref, ref.flash_attention_ref)
    with _chip_smoke().reversed_sums(torch):
        got = ops.moe_gmm(x, w, impl="ref")
        assert ref.flash_attention_ref is not plain[1]
    assert (ref.moe_gmm_ref, ref.flash_attention_ref) == plain
    _close(got, ref.moe_gmm_ref(x, w), scaled=True)


def test_chip_smoke_forced_gaps(pair):
    """chip_smoke.py's bfloat16 OLMoE comparison, where the plain run
    chooses the tokens and the kernels and the witness take its inputs
    at every call: on the CPU the kernels' route is the plain version
    (gap 0) and the witness parts from it by float32 rounding only."""
    model, _, _ = pair
    smoke = _chip_smoke()
    rng = np.random.RandomState(8)
    prompts = [rng.randint(2, CFG.vocab, size=n).tolist() for n in (5, 9)]
    gaps = smoke.forced_gaps(torch, model, prompts, smoke.reversed_sums)
    budget = smoke.SERVE_CONFIG["max_new_tokens"] + 1
    assert gaps["kernels"] == {"max_abs": 0.0, "rel_l2": 0.0,
                               "rows": gaps["witness"]["rows"]}
    assert len(prompts) <= gaps["witness"]["rows"] <= len(prompts) * budget
    assert 0.0 < gaps["witness"]["max_abs"] < 1e-4
    assert model.impl is None


def test_golden_is_well_formed_and_matches_chip_smoke():
    with open(GOLDEN) as f:
        g = json.load(f)
    smoke = _chip_smoke()
    assert g["arch"] == smoke.OLMOE_ARCH == ARCH
    assert g["seed"] == smoke.SERVE_SEED
    assert g["serve"] == smoke.SERVE_CONFIG
    assert g["dtype"] == "float32"
    cfg = configs.get_config(ARCH).replace(n_layers=smoke.OLMOE_F32_LAYERS)
    assert g["config"] == {k: getattr(cfg, k) for k in g["config"]}
    assert g["config"]["n_layers"] == 4 and g["config"]["d_model"] == 2048
    assert g["config"]["n_experts"] == 64 and g["config"]["top_k"] == 8
    reqs = g["requests"]
    assert len(reqs) == smoke.OLMOE_REQUESTS > g["serve"]["max_slots"]
    assert [r["prompt"] for r in reqs] == [
        p.tolist() for p in golden_requests(g["seed"], len(reqs),
                                            cfg.vocab)]
    calls = sorted({c for r in reqs for c in r["calls"]})
    assert calls == list(range(g["n_calls"]))
    for r in reqs:
        n = len(r["tokens"])
        assert 1 <= n <= g["serve"]["max_new_tokens"] + 1
        assert len(r["top5_values"]) == len(r["top5_indices"]) == n
        assert len(r["top2_margin"]) == len(r["calls"]) == n
        assert r["calls"] == sorted(r["calls"])
        for vals, idx, tok, margin in zip(r["top5_values"],
                                          r["top5_indices"], r["tokens"],
                                          r["top2_margin"]):
            assert idx[0] == tok and len(vals) == len(idx) == 5
            assert vals == sorted(vals, reverse=True)
            assert margin == pytest.approx(vals[0] - vals[1])
        if n < g["serve"]["max_new_tokens"] + 1:
            assert r["tokens"][-1] == g["serve"]["eos_id"]
    ema = np.asarray(g["final_load_ema"])
    assert ema.shape == (4, 64) and (ema > 0).all()


# -------------------------------------------------------------- the golden
def _record_calls(engine, **kw):
    """`_record`'s (rid, row) log of the JAX engine, and beside it the
    index of the engine call (a prefill or a decode step) behind each
    row."""
    log, calls, n = _record(engine, **kw), [], [0]
    admit, step = engine.admit, engine.step

    def counted(fn):
        def run(*args):
            k = len(log)
            out = fn(*args)
            if len(log) > k:
                calls.extend([n[0]] * (len(log) - k))
                n[0] += 1
            return out
        return run

    engine.admit, engine.step = counted(admit), counted(step)
    return log, calls


def write_golden(path=GOLDEN):
    smoke = _chip_smoke()
    seed, scfg = smoke.SERVE_SEED, smoke.SERVE_CONFIG
    n_layers = smoke.OLMOE_F32_LAYERS
    cfg = jconfigs.get_config(smoke.OLMOE_ARCH).replace(
        n_layers=n_layers, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32)
    tcfg = configs.get_config(smoke.OLMOE_ARCH).replace(n_layers=n_layers)
    t0 = time.perf_counter()
    jmodel = j_build_model(cfg)
    from repro_torch.models.lm import LM
    tree = module.init(LM(tcfg, device="meta").param_specs(), seed)

    def to_jax(t):        # leaf by leaf, so the numpy copy goes at once
        return {k: to_jax(t.pop(k)) if isinstance(t[k], dict)
                else jnp.asarray(t.pop(k)) for k in sorted(t)}
    params = to_jax(tree)
    print(f"weights: {time.perf_counter() - t0:.1f} s", flush=True)
    engine = JServingEngine(jmodel, params, JServeConfig(**scfg),
                            mstate=_j_state(jmodel))
    log, calls = _record_calls(engine, prefill=jax.jit(jmodel.prefill))
    prompts = golden_requests(seed, smoke.OLMOE_REQUESTS, cfg.vocab)
    reqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    engine.run(reqs)
    rows = {r.rid: [] for r in reqs}
    for (rid, row), call in zip(log, calls):
        rows[rid].append((row, call))
    out = {"arch": smoke.OLMOE_ARCH, "seed": seed, "serve": scfg,
           "dtype": "float32",
           "config": {k: getattr(tcfg, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "n_experts", "top_k", "d_ff_expert", "capacity_factor",
               "router_bias", "router_bias_eta", "vocab", "qk_norm",
               "rope_theta", "norm_eps", "tie_embeddings")},
           "jax": jax.__version__, "n_calls": max(calls) + 1,
           "final_load_ema": np.asarray(
               engine.mstate["slot_00"]["load_ema"]).tolist(),
           "requests": []}
    for r in reqs:
        top_i = [np.argsort(-row, kind="stable")[:5] for row, _ in
                 rows[r.rid]]
        top_v = [row[i] for (row, _), i in zip(rows[r.rid], top_i)]
        out["requests"].append({
            "rid": r.rid, "prompt": [int(t) for t in r.prompt],
            "tokens": [int(t) for t in r.out],
            "calls": [int(c) for _, c in rows[r.rid]],
            "top5_indices": [[int(j) for j in i] for i in top_i],
            "top5_values": [[float(x) for x in v] for v in top_v],
            "top2_margin": [float(v[0] - v[1]) for v in top_v]})
        print(r.rid, len(r.prompt), r.out[:6], flush=True)
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {path} in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
