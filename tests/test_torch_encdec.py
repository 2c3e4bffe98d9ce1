"""The port's encoder-decoder LM (`repro_torch.models.EncDecLM`) against
the JAX package's `repro.models.EncDecLM` at the reduced whisper-base
config (2 encoder and 2 decoder layers, 24 frames, d 64, 4 heads on 2
KV heads, hd 16, vocab 256, float32), fed the same numpy weights, and
K4's plain version on cross lengths (Sk != Sq) against the JAX
`full_attention` cross path.

Tolerances: logits and the encoder output rtol = atol = 1e-5, caches
rtol 1e-5 with atol 1e-5 of their largest magnitude (as
`test_torch_lm.py`), each atol raised to three times a one-ulp
witness's move where that is more (this random model, without qk-norm,
turns float32 rounding into up to 5e-5 of logit).  With the engine's
zero frame features the encoder output is exactly zero (rmsnorm(0) = 0,
so q, k, v and the MLP are 0) and the cross attention adds nothing, so
every model-level check also runs on random features.

Run as a script, this file writes the golden that `chip_smoke.py`'s
whisper phase holds the card's float32 run against:

    PYTHONPATH=src python tests/test_torch_encdec.py --write-golden

the JAX engine on the CPU at full whisper-base width in float32 (the
12 serving requests, zero features), then the random-feature record:
two prompts of 333 and 64 tokens prefilled into two lanes on frame
features from `RandomState(SERVE_SEED).standard_normal([2, 1500,
512])`, and 16 greedy decode steps of both.
"""
import contextlib
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
from repro.kernels import ops as jops
from repro.models import EncDecLM as JEncDecLM
from repro.models import module as jmodule
from repro.models.layers import attention as jattn
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.serve import load_model, main as serve_main
from repro_torch.models import EncDecLM, build_model, module
from repro_torch.models.layers import attention as attn
from repro_torch.serving import Request, ServeConfig, ServingEngine
from test_torch_serving import _chip_smoke, _record, golden_requests

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_serve_whisper.json")
ARCH = "whisper-base"
LOGITS = dict(rtol=1e-5, atol=1e-5)
# the random-feature record: prompt lengths, decode steps
FEAT_PROMPTS, FEAT_STEPS = (333, 64), 16

JE = JEncDecLM(jconfigs.get_reduced(ARCH))
j_encode = jax.jit(JE.encode)
j_prefill = jax.jit(JE.prefill)
j_decode = jax.jit(JE.decode_step)
SLOTS, MAX_LEN, PROMPT = 2, 24, 9


@pytest.fixture(scope="module")
def pair():
    cfg = configs.get_reduced(ARCH)
    model = load_model(cfg, seed=1, device="cpu")
    tree = module.init(model.param_specs(), 1)
    return cfg, model, jax.tree.map(jnp.asarray, tree)


def _features(cfg, kind, seed=0):
    shape = (SLOTS, cfg.n_enc_frames, cfg.d_model)
    if kind == "zero":
        return np.zeros(shape, np.float32)
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@contextlib.contextmanager
def _ulp_up(model):
    """Within it every entry of the port's embedding table is one ulp up
    (times 1 + 2^-23)."""
    saved = model.embed.detach().clone()
    with torch.no_grad():
        model.embed.mul_(1.0 + 2.0 ** -23)
    try:
        yield
    finally:
        with torch.no_grad():
            model.embed.copy_(saved)


def _port_run(model, cfg, feats):
    """The encoder output of both rows' features; each prompt prefilled
    into its own lane of a 2-lane cache with its row's features (as the
    engine admits); three decode steps over both lanes at different
    positions.  Returns ({"encode", "logits": [...], "prefill_cache",
    "cache"}, the prompts and decode tokens fed)."""
    out = {"encode": model.encode(torch.from_numpy(feats)), "logits": []}
    tc = module.zeros(model.init_cache_specs(SLOTS, MAX_LEN), "cpu")
    rng = np.random.RandomState(0)
    fed = []
    for slot in range(SLOTS):
        p = rng.randint(2, cfg.vocab, (1, PROMPT))
        lane = module.tree_map(lambda c: c[:, slot:slot + 1], tc)
        logits, state, _ = model.prefill({}, lane, torch.as_tensor(p),
                                         torch.from_numpy(feats[slot:slot
                                                                + 1]))
        assert state == {}
        out["logits"].append(logits)
        fed.append(p)
    out["prefill_cache"] = module.tree_map(torch.clone, tc)
    pos = np.array([PROMPT, PROMPT - 3], np.int32)
    for _ in range(3):
        tk = rng.randint(2, cfg.vocab, (SLOTS, 1))
        logits, _, tc = model.decode_step({}, tc, torch.as_tensor(tk),
                                          torch.as_tensor(pos))
        out["logits"].append(logits)
        fed.append((tk, pos.copy()))
        pos = pos + 1
    out["cache"] = tc
    return out, fed


def _reference_run(jp, feats, fed):
    zeros = jax.tree.map(lambda s: jnp.asarray(np.zeros(s.shape, s.dtype)),
                         JE.init_cache_specs(1, MAX_LEN),
                         is_leaf=lambda x: isinstance(x, jmodule.ParamSpec))
    out = {"encode": j_encode(jp, jnp.asarray(feats)), "logits": []}
    lanes = []
    for slot in range(SLOTS):
        logits, _, lane = j_prefill(jp, {}, zeros, jnp.asarray(fed[slot]),
                                    jnp.asarray(feats[slot:slot + 1]))
        out["logits"].append(logits)
        lanes.append(lane)
    jc = jax.tree.map(lambda *c: jnp.asarray(np.concatenate(c, axis=1)),
                      *lanes)
    out["prefill_cache"] = jc
    for tk, pos in fed[SLOTS:]:
        logits, _, jc = j_decode(jp, {}, jc, jnp.asarray(tk),
                                 jnp.asarray(pos))
        out["logits"].append(logits)
    out["cache"] = jc
    return out


def _witness_atol(got, shifted, floor=1e-5):
    """atol: `floor`, or three times the one-ulp witness's largest move
    over all of `got` where that is more."""
    move = max(float((a - b).abs().max()) for a, b in zip(got, shifted))
    return max(floor, 3 * move)


@pytest.mark.parametrize("kind", ["random", "zero"])
def test_encode_prefill_and_decode_match_reference(pair, kind):
    """`encode` on both rows' features, each prompt prefilled into its
    own lane with its row's features, three decode steps over both
    lanes: the encoder output and every call's logits at rtol = atol =
    1e-5, the self and cross caches after the prefills and at the end at
    rtol 1e-5 with atol 1e-5 of their largest magnitude, each atol
    raised to three times the witness's largest move where that is more.
    The witness is the port's own run with its float32 rounding moved:
    the features and the embedding table one ulp up (times 1 + 2^-23).
    This random model amplifies rounding: with the frame features
    standard normal the witness moves the logits by up to 5e-5 and the
    self caches by 5e-4, as far as the reference is from the port
    (ROADMAP §3).  On zero features the encoder output and the cross
    caches are exactly zero."""
    cfg, model, jp = pair
    feats = _features(cfg, kind)
    got, fed = _port_run(model, cfg, feats)
    with _ulp_up(model):
        shifted, _ = _port_run(
            model, cfg, (feats * np.float32(1 + 2 ** -23)).astype(np.float32))
    want = _reference_run(jp, feats, fed)
    atol = _witness_atol([got["encode"]], [shifted["encode"]])
    np.testing.assert_allclose(got["encode"].numpy(),
                               np.asarray(want["encode"]), rtol=1e-5,
                               atol=atol)
    atol = _witness_atol(got["logits"], shifted["logits"])
    for t, j in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=atol)
    for which in ("prefill_cache", "cache"):
        for name in ("self_k", "self_v", "cross_k", "cross_v"):
            t, j = got[which][name], np.asarray(want[which][name])
            atol = _witness_atol([t], [shifted[which][name]],
                                 1e-5 * max(1.0, np.abs(j).max()))
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=atol)
    if kind == "zero":
        assert not got["encode"].any()
        assert not got["cache"]["cross_k"].any()
        assert not got["cache"]["cross_v"].any()


def test_engine_matches_reference(pair):
    """5 requests on 2 slots through both engines (each prefill on the
    zero frame features of the JAX engine's stub): the same tokens, the
    logits behind each at rtol = atol = 1e-5, atol raised to three times
    the largest move of the witness (the port's engine with its
    embedding table one ulp up, which hands out the same tokens) where
    that is more."""
    cfg, model, jp = pair
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, cfg.vocab, size=PROMPT).astype(np.int32)
               for _ in range(5)]
    scfg = dict(max_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=6)

    def port_serve():
        log = []
        engine = ServingEngine(model, ServeConfig(**scfg))
        _chip_smoke().watch_tokens(engine, lambda r, row: log.append(
            (r.rid, row.clone())))
        reqs = [Request(i, p) for i, p in enumerate(prompts)]
        engine.run(reqs)
        return reqs, log

    treqs, tlog = port_serve()
    with _ulp_up(model):
        wreqs, wlog = port_serve()
    assert [r.out for r in wreqs] == [r.out for r in treqs]
    jengine = JServingEngine(JE, jp, JServeConfig(**scfg))
    jlog = _record(jengine, prefill=j_prefill, decode=j_decode)
    jreqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    jengine.run(jreqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert [rid for rid, _ in tlog] == [rid for rid, _ in jlog]
    atol = _witness_atol([t for _, t in tlog], [w for _, w in wlog])
    for (_, t), (_, j) in zip(tlog, jlog):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=atol)


def test_weights_carry_over(pair):
    """The state dict mirrors the JAX tree (layer g of each stack is
    layer g, the attention matrices reshaped), and a tree that does not
    match the model is refused."""
    from repro_torch.convert import lm_leaf_dtypes, lm_params_from_numpy
    cfg, model, _ = pair
    tree = module.init(model.param_specs(), 1)
    sd = lm_params_from_numpy(cfg, tree, "cpu")
    assert set(sd) == set(model.state_dict())
    d = cfg.d_model
    for g in range(cfg.n_layers):
        x = tree["dec_blocks"]["cross_attn"]["wk"][g]
        np.testing.assert_array_equal(sd[f"dec_blocks.{g}.cross_attn.wk"]
                                      .numpy(), x.reshape(d, -1))
        np.testing.assert_array_equal(sd[f"dec_blocks.{g}.lnx"].numpy(),
                                      tree["dec_blocks"]["lnx"][g])
    dtype_of = lm_leaf_dtypes(model)
    for path, s in module.leaves(model.param_specs()):
        assert dtype_of(path, s) == torch.float32
    bad = dict(tree, enc_blocks=dict(tree["enc_blocks"]))
    del bad["enc_blocks"]["ln2"]
    with pytest.raises((KeyError, ValueError)):
        lm_params_from_numpy(cfg, bad, "cpu")


def test_full_width_builds_and_counts():
    """At full width (meta device): the JAX package's parameter count,
    the cache specs of its `init_cache_specs`, and the compute dtype
    for the matrices, the parameter dtype for the norm scales."""
    cfg = configs.get_config(ARCH)
    model = build_model(cfg, device="meta")
    assert isinstance(model, EncDecLM)
    je = JEncDecLM(jconfigs.get_config(ARCH))
    n = sum(t.numel() for t in model.state_dict().values())
    assert n == module.param_count(model.param_specs()) \
        == jmodule.param_count(je.param_specs())
    assert model.dec_blocks[0].cross_attn["wq"].dtype == cfg.compute_dtype
    assert model.dec_blocks[0].lnx.dtype == cfg.param_dtype
    specs = model.init_cache_specs(8, 1024)
    jspecs = je.init_cache_specs(8, 1024)
    for k, s in specs.items():
        assert (s.shape, s.axes) == (jspecs[k].shape, jspecs[k].axes)
    assert specs["cross_k"].shape == (6, 8, 1500, 8, 64)


# --------------------------------------------------- K4 on cross lengths
@pytest.mark.parametrize("L, block_q", [(5, 512), (16, 8)],
                         ids=["naive", "qblocked"])
def test_cross_attention_matches_reference(L, block_q):
    """q of L rows against k, v of F = 24 frames, not causal, through
    the dispatcher's plain version, against the JAX `full_attention`
    cross path: its naive branch (L <= block_q) and its q-blocked one
    (L > block_q, L % block_q == 0)."""
    rng = np.random.RandomState(L)
    B, H, KV, hd, F = 2, 4, 2, 16, 24
    q = rng.standard_normal((B, L, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, F, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, F, KV, hd)).astype(np.float32)
    want = jax.jit(lambda q, k, v: jattn.full_attention(
        q, k, v, causal=False, block_q=block_q))(q, k, v)
    got = attn.full_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    assert got.shape == (B, L, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    with pytest.raises(ValueError, match="causal"):
        attn.full_attention(*map(torch.from_numpy, (q, k, v)), causal=True)


def test_noncausal_matches_pallas_interpret():
    """Non-causal attention of equal lengths (the encoder's) through the
    Pallas kernel body in interpret mode, as the K4 tests run it."""
    rng = np.random.RandomState(7)
    q = rng.standard_normal((1, 4, 24, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        impl="pallas_interpret"))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS)


@pytest.mark.parametrize("dims", [False, True])
def test_chip_smoke_witness_on_cross_lengths(dims):
    """chip_smoke.py's bfloat16 witnesses, the plain attention with the
    keys in reverse order (and with `dims` the head dims too), compute
    the plain attention on cross lengths, causal and in decode (f32: to
    rounding, 1e-6), and give the plain versions back on exit."""
    from repro_torch.kernels import ref
    rng = np.random.RandomState(8)

    def t(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    q, k, v, qc = t(1, 4, 9, 16), t(1, 2, 24, 16), t(1, 2, 24, 16), \
        t(1, 4, 24, 16)
    qd, kc, vc = t(3, 2, 2, 16), t(3, 20, 2, 16), t(3, 20, 2, 16)
    lengths = torch.tensor([1, 20, 7], dtype=torch.int32)
    plain = (ref.flash_attention_ref, ref.decode_attention_ref)
    with _chip_smoke().reversed_keys(torch, dims=dims):
        got = (ops.flash_attention(q, k, v, causal=False, impl="ref"),
               ops.flash_attention(qc, k, v, causal=True, impl="ref"),
               ops.decode_attention(qd, kc, vc, lengths, impl="ref"))
    assert (ref.flash_attention_ref, ref.decode_attention_ref) == plain
    want = (ref.flash_attention_ref(q, k, v, causal=False),
            ref.flash_attention_ref(qc, k, v, causal=True),
            ref.decode_attention_ref(qd, kc, vc, lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_serve_launcher_serves_whisper(capsys):
    """The launcher serves the reduced whisper-base on the CPU, its first
    line the router's plan as the JAX launcher prints it."""
    assert serve_main(["--arch", ARCH, "--device", "cpu", "--max-new",
                       "2", "--slots", "2", "--max-len", "32"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "router: cost=0.069 pod_util=[0.02 0.  ]"
    assert out[1].startswith("served 8 requests")


# ------------------------------------------------------------- the golden
def test_golden_is_well_formed_and_matches_chip_smoke():
    with open(GOLDEN) as f:
        g = json.load(f)
    smoke = _chip_smoke()
    assert g["arch"] == smoke.WHISPER_ARCH == ARCH
    assert g["seed"] == smoke.SERVE_SEED
    assert g["serve"] == smoke.SERVE_CONFIG
    assert g["dtype"] == "float32" and g["jax"] and g["seconds"] > 0
    cfg = configs.get_config(ARCH)
    assert g["config"] == {k: getattr(cfg, k) for k in g["config"]}
    assert g["config"]["n_enc_frames"] == 1500
    reqs = g["requests"]
    assert len(reqs) == smoke.WHISPER_REQUESTS > g["serve"]["max_slots"]
    assert [r["prompt"] for r in reqs] == [p.tolist() for p in
                                           golden_requests(g["seed"],
                                                           len(reqs),
                                                           cfg.vocab)]
    _well_formed(reqs, g["serve"])
    feat = g["random_features"]
    assert feat["seed"] == smoke.SERVE_SEED
    assert feat["shape"] == [2, cfg.n_enc_frames, cfg.d_model]
    assert [len(r["prompt"]) for r in feat["requests"]] == list(FEAT_PROMPTS)
    assert feat["decode_steps"] == FEAT_STEPS == smoke.WHISPER_FEAT_STEPS
    for r in feat["requests"]:
        assert len(r["tokens"]) == FEAT_STEPS + 1
    _well_formed(feat["requests"], None)


def _well_formed(reqs, serve):
    for r in reqs:
        n = len(r["tokens"])
        assert len(r["top5_values"]) == len(r["top5_indices"]) == n
        assert len(r["top2_margin"]) == n
        for vals, idx, tok, margin in zip(r["top5_values"],
                                          r["top5_indices"], r["tokens"],
                                          r["top2_margin"]):
            assert idx[0] == tok and len(vals) == len(idx) == 5
            assert vals == sorted(vals, reverse=True)
            assert margin == pytest.approx(vals[0] - vals[1])
        if serve is not None:
            assert 1 <= n <= serve["max_new_tokens"] + 1
            if n < serve["max_new_tokens"] + 1:
                assert r["tokens"][-1] == serve["eos_id"]


def _top5(rows):
    top_i = [np.argsort(-row, kind="stable")[:5] for row in rows]
    top_v = [row[i] for row, i in zip(rows, top_i)]
    return {"top5_indices": [[int(j) for j in i] for i in top_i],
            "top5_values": [[float(x) for x in v] for v in top_v],
            "top2_margin": [float(v[0] - v[1]) for v in top_v]}


def feature_prompts(seed: int, vocab: int) -> list:
    """The random-feature record's prompts: FEAT_PROMPTS lengths of
    tokens from RandomState(seed + 1)."""
    rng = np.random.RandomState(seed + 1)
    return [rng.randint(2, vocab, size=n).astype(np.int32)
            for n in FEAT_PROMPTS]


def write_golden(path=GOLDEN):
    smoke = _chip_smoke()
    seed, scfg = smoke.SERVE_SEED, smoke.SERVE_CONFIG
    cfg = jconfigs.get_config(ARCH).replace(compute_dtype=jnp.float32,
                                            cache_dtype=jnp.float32)
    tcfg = configs.get_config(ARCH)
    t0 = time.perf_counter()
    jmodel = JEncDecLM(cfg)
    tree = module.init(EncDecLM(tcfg, device="meta").param_specs(), seed)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    engine = JServingEngine(jmodel, params, JServeConfig(**scfg))
    log = _record(engine, prefill=prefill)
    prompts = golden_requests(seed, smoke.WHISPER_REQUESTS, cfg.vocab)
    reqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    engine.run(reqs)
    rows = {r.rid: [] for r in reqs}
    for rid, row in log:
        rows[rid].append(row)
    out = {"arch": ARCH, "seed": seed, "serve": scfg, "dtype": "float32",
           "config": {k: getattr(tcfg, k) for k in (
               "n_layers", "n_enc_layers", "n_enc_frames", "d_model",
               "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
               "qk_norm", "rope_theta", "norm_eps")},
           "jax": jax.__version__, "requests": []}
    for r in reqs:
        out["requests"].append({"rid": r.rid,
                                "prompt": [int(t) for t in r.prompt],
                                "tokens": [int(t) for t in r.out],
                                **_top5(rows[r.rid])})
        print(r.rid, len(r.prompt), r.out[:6], flush=True)

    # the random-feature record: two lanes, then greedy decode steps
    shape = [2, cfg.n_enc_frames, cfg.d_model]
    feats = np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jmodel.init_cache_specs(1, scfg["max_len"]),
                         is_leaf=lambda x: isinstance(x, jmodule.ParamSpec))
    fprompts = feature_prompts(seed, cfg.vocab)
    lanes, frows = [], [[], []]
    for b, p in enumerate(fprompts):
        logits, _, lane = prefill(params, {}, zeros, jnp.asarray(p[None]),
                                  enc_feats=jnp.asarray(feats[b:b + 1]))
        lanes.append(lane)
        frows[b].append(np.asarray(logits[0]))
    cache = jax.tree.map(lambda *c: jnp.concatenate(c, axis=1), *lanes)
    pos = np.array([len(p) for p in fprompts], np.int32)
    for _ in range(FEAT_STEPS):
        toks = np.array([[int(np.argmax(r[-1]))] for r in frows], np.int32)
        logits, _, cache = decode(params, {}, cache, jnp.asarray(toks),
                                  jnp.asarray(pos))
        for b in range(2):
            frows[b].append(np.asarray(logits[b]))
        pos = pos + 1
    out["random_features"] = {
        "seed": seed, "shape": shape, "decode_steps": FEAT_STEPS,
        "requests": [{"prompt": [int(t) for t in p],
                      "tokens": [int(np.argmax(r)) for r in rows_b],
                      **_top5(rows_b)}
                     for p, rows_b in zip(fprompts, frows)]}
    print("random features:", [r["tokens"][:6] for r in
                               out["random_features"]["requests"]])
    out["seconds"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {path} in {out['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
