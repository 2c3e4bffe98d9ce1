"""M-RoPE and the VLM (qwen2-vl-7b) in the port against the JAX package.

`rope.mrope_angles` on distinct temporal / height / width positions
(atol 1e-6: the two packages' float32 frequencies differ by an ulp in
a few bands, which positions below 64 keep under 5e-7), `make_positions`
exactly, and the port's `LM` at the reduced qwen2-vl-7b config (2
layers, d 64, 4 heads on 2 KV heads, hd 16, M-RoPE sections (2, 3, 3),
vocab 256, float32) against the JAX `LM` on the same numpy weights:
prefill into two lanes and three decode steps, and an engine serve,
logits at rtol = atol = 1e-5 (the serve's atol raised to three times a
one-ulp witness's move where that is more) and caches at rtol 1e-5 with
atol 1e-5 of their largest magnitude.  A text-only prompt feeds one
position to all three components, which is standard RoPE whatever the
sections are, so only the unit tests with distinct components hold the
section mapping.

Run as a script, this file writes the golden that `chip_smoke.py`'s
VLM phase holds the card's float32 run against:

    PYTHONPATH=src python tests/test_torch_vlm.py --write-golden

the JAX engine on the CPU at full qwen2-vl-7b width, cut to
`VLM_F32_LAYERS` (4) of its 28 layers, in float32, on the 12 serving
requests.
"""
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
from repro.models import LM as JLM
from repro.models import build_model as j_build_model
from repro.models import module as jmodule
from repro.models.layers import rope as jrope
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.launch.serve import load_model
from repro_torch.models import module
from repro_torch.models.layers import rope
from repro_torch.serving import Request, ServeConfig, ServingEngine
from test_torch_encdec import _top5, _ulp_up, _well_formed, _witness_atol
from test_torch_serving import _chip_smoke, _record, golden_requests

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_serve_qwen2vl.json")
ARCH = "qwen2-vl-7b"
LOGITS = dict(rtol=1e-5, atol=1e-5)

JL = JLM(jconfigs.get_reduced(ARCH))
j_prefill = jax.jit(JL.prefill)
j_decode = jax.jit(JL.decode_step)
j_mrope = jax.jit(jrope.mrope_angles, static_argnums=(0, 1, 3))
SLOTS, MAX_LEN, PROMPT = 2, 24, 9


def _positions(seed=0, B=2, L=7):
    """[3, B, L] positions, each component drawn on its own from [0, 64)."""
    return np.random.RandomState(seed).randint(0, 64, (3, B, L)).astype(
        np.int32)


# ----------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("hd, sections", [(16, (2, 3, 3)),
                                          (128, (16, 24, 24))])
def test_mrope_angles_match_reference(hd, sections):
    pos = _positions()
    assert len({tuple(p.ravel()) for p in pos}) == 3    # distinct t/h/w
    c, s = rope.mrope_angles(hd, 1e6, torch.from_numpy(pos), sections)
    jc, js = j_mrope(hd, 1e6, jnp.asarray(pos), sections)
    assert c.shape == (2, 7, hd // 2)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_mrope_section_mapping():
    """Another order of the sections gives other angles on distinct
    components (so the test above holds the mapping); one position in
    all three components is standard RoPE; sections that do not sum to
    hd/2 raise."""
    pos = torch.from_numpy(_positions())
    jc, _ = j_mrope(16, 1e6, jnp.asarray(pos.numpy()), (2, 3, 3))
    c, _ = rope.mrope_angles(16, 1e6, pos, (3, 2, 3))
    assert np.abs(c.numpy() - np.asarray(jc)).max() > 1e-2
    same = pos[:1].expand(3, -1, -1)
    for got, want in zip(rope.mrope_angles(16, 1e6, same, (2, 3, 3)),
                         rope.rope_angles(16, 1e6, pos[0])):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="sum"):
        rope.mrope_angles(16, 1e6, pos, (2, 3, 2))


def test_make_positions_matches_reference():
    off = np.array([0, 5, 17], np.int32)
    for offset in (None, off):
        want = np.asarray(jrope.make_positions(
            3, 11, None if offset is None else jnp.asarray(offset)))
        got = rope.make_positions(
            3, 11, None if offset is None else torch.from_numpy(offset))
        np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def pair():
    cfg = configs.get_reduced(ARCH)
    assert cfg.mrope_sections == (2, 3, 3)
    model = load_model(cfg, seed=1, device="cpu")
    tree = module.init(model.param_specs(), 1)
    return cfg, model, jax.tree.map(jnp.asarray, tree)


def _cache_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_prefill_and_decode_match_reference(pair):
    """Two prompts, each prefilled into its own lane of a 2-lane cache,
    then three decode steps over both lanes at different positions:
    logits and caches."""
    cfg, model, jp = pair
    tc = module.zeros(model.init_cache_specs(SLOTS, MAX_LEN), "cpu")
    zeros = jax.tree.map(lambda s: jnp.asarray(np.zeros(s.shape, s.dtype)),
                         JL.init_cache_specs(1, MAX_LEN),
                         is_leaf=lambda x: isinstance(x, jmodule.ParamSpec))
    rng = np.random.RandomState(0)
    jlanes = []
    for slot in range(SLOTS):
        p = rng.randint(2, cfg.vocab, (1, PROMPT))
        lane = module.tree_map(lambda c: c[:, slot:slot + 1], tc)
        tlog, _, _ = model.prefill({}, lane, torch.as_tensor(p))
        jlog, _, jlane = j_prefill(jp, {}, zeros, jnp.asarray(p))
        jlanes.append(jlane)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    jc = jax.tree.map(lambda *c: jnp.asarray(np.concatenate(c, axis=1)),
                      *jlanes)
    pos = np.array([PROMPT, PROMPT - 3], np.int32)
    for _ in range(3):
        tk = rng.randint(2, cfg.vocab, (SLOTS, 1))
        tlog, _, tc = model.decode_step({}, tc, torch.as_tensor(tk),
                                        torch.as_tensor(pos))
        jlog, _, jc = j_decode(jp, {}, jc, jnp.asarray(tk), jnp.asarray(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
        pos = pos + 1
    for name in ("k", "v"):
        _cache_close(tc["slot_00"][name], jc["slot_00"][name])


def test_engine_matches_reference(pair):
    """5 requests on 2 slots through both engines: the same tokens, the
    logits behind each at rtol = atol = 1e-5, atol raised to three times
    the largest move of the witness (the port's engine with its
    embedding table one ulp up, which hands out the same tokens) where
    that is more: without qk-norm this random model turns float32
    rounding into up to 2.3e-5 of logit over the serve's 35 calls."""
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
    jengine = JServingEngine(JL, jp, JServeConfig(**scfg))
    jlog = _record(jengine, prefill=j_prefill, decode=j_decode)
    jreqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    jengine.run(jreqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert [rid for rid, _ in tlog] == [rid for rid, _ in jlog]
    atol = _witness_atol([t for _, t in tlog], [w for _, w in wlog])
    for (_, t), (_, j) in zip(tlog, jlog):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=atol)


# ------------------------------------------------------------- the golden
def test_golden_is_well_formed_and_matches_chip_smoke():
    with open(GOLDEN) as f:
        g = json.load(f)
    smoke = _chip_smoke()
    assert g["arch"] == smoke.VLM_ARCH == ARCH
    assert g["seed"] == smoke.SERVE_SEED
    assert g["serve"] == smoke.SERVE_CONFIG
    assert g["dtype"] == "float32" and g["jax"] and g["seconds"] > 0
    cfg = configs.get_config(ARCH).replace(n_layers=smoke.VLM_F32_LAYERS)
    assert g["config"] == json.loads(json.dumps(
        {k: getattr(cfg, k) for k in g["config"]}))
    assert g["config"]["d_model"] == 3584
    assert g["config"]["mrope_sections"] == [16, 24, 24]
    reqs = g["requests"]
    assert len(reqs) == smoke.VLM_REQUESTS > g["serve"]["max_slots"]
    assert [r["prompt"] for r in reqs] == [p.tolist() for p in
                                           golden_requests(g["seed"],
                                                           len(reqs),
                                                           cfg.vocab)]
    _well_formed(reqs, g["serve"])


def write_golden(path=GOLDEN):
    smoke = _chip_smoke()
    seed, scfg = smoke.SERVE_SEED, smoke.SERVE_CONFIG
    n_layers = smoke.VLM_F32_LAYERS
    cfg = jconfigs.get_config(ARCH).replace(
        n_layers=n_layers, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32)
    tcfg = configs.get_config(ARCH).replace(n_layers=n_layers)
    t0 = time.perf_counter()
    jmodel = j_build_model(cfg)
    from repro_torch.models.lm import LM
    tree = module.init(LM(tcfg, device="meta").param_specs(), seed)

    def to_jax(t):        # leaf by leaf, so the numpy copy goes at once
        return {k: to_jax(t.pop(k)) if isinstance(t[k], dict)
                else jnp.asarray(t.pop(k)) for k in sorted(t)}
    params = to_jax(tree)
    print(f"weights: {time.perf_counter() - t0:.1f} s", flush=True)
    engine = JServingEngine(jmodel, params, JServeConfig(**scfg))
    log = _record(engine, prefill=jax.jit(jmodel.prefill))
    prompts = golden_requests(seed, smoke.VLM_REQUESTS, cfg.vocab)
    reqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    engine.run(reqs)
    rows = {r.rid: [] for r in reqs}
    for rid, row in log:
        rows[rid].append(row)
    out = {"arch": ARCH, "seed": seed, "serve": scfg, "dtype": "float32",
           "config": {k: getattr(tcfg, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab", "qk_norm", "rope_theta", "mrope_sections",
               "norm_eps", "tie_embeddings")},
           "jax": jax.__version__, "requests": []}
    for r in reqs:
        out["requests"].append({"rid": r.rid,
                                "prompt": [int(t) for t in r.prompt],
                                "tokens": [int(t) for t in r.out],
                                **_top5(rows[r.rid])})
        print(r.rid, len(r.prompt), r.out[:6], flush=True)
    out["seconds"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {path} in {out['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
