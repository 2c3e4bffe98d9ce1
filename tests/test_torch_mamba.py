"""The port's Mamba2 path against the JAX package's, at the reduced
mamba2-130m config (2 layers, d 64, d_inner 128, 8 SSM heads of P 16,
N 16, chunk 16, vocab 256, float32), on the same numpy weights:

* the mixer (`models.layers.mamba`): `mamba` (the prefill, with all four
  cache pieces) at L in {1, 2, 16, 32} and `mamba_decode` from each
  cache, against `repro.models.layers.mamba` (outputs rtol = atol =
  1e-5, caches the same with atol scaled to their largest magnitude);
* the LM (`models.lm.LM` through `convert.lm_params_from_numpy`):
  prefill into two slots, then decode steps, logits and every cache
  leaf, at the same tolerances;
* the serving engines: the same requests give the same tokens through
  `repro_torch.serving.ServingEngine` and `repro.serving.ServingEngine`,
  the logits behind every token to rtol = atol = 1e-5; a slot reused
  after another request finished in it serves as a fresh one;
* the chunk contract, the launcher, `chip_smoke.py`'s witness and the
  stored full-width golden.

The JAX mixer's outputs at the four lengths are stored in
`src/repro_torch/data/reference_mamba.npz` (compiling them costs ~8 s
on one core); one length is recomputed live against the stored file.
The JAX LM's prefill and decode are compiled at XLA's lowest backend
optimisation level (the same function, half the compile time).  Run as
a script, this file rewrites the stored outputs, or writes the golden:

    PYTHONPATH=src python tests/test_torch_mamba.py --write-references
    PYTHONPATH=src python tests/test_torch_mamba.py --write-golden

the latter the JAX `ServingEngine` on the CPU at full mamba2-130m width
in float32, weights from the port's `models.module.init` (numpy) and
seed 0, the 12 requests of `chip_smoke.py`'s Mamba2 serving phase; it
records each request's tokens and, for every token, the top-5 logits
and the top-2 margin.  `--float32-witness` prints, for each golden
request, the CPU port's float32 prefill gap from the golden beside
`chip_smoke.py`'s one-ulp witness.
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
from repro.models import module as jmodule
from repro.models.layers import mamba as jmb
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import load_model, main as serve_main
from repro_torch.models import build_model, module
from repro_torch.models.layers import mamba as mb
from repro_torch.models.layers.ssd import ssd_chunked, ssd_sequential
from repro_torch.serving import Request, ServeConfig, ServingEngine
from test_torch_serving import _chip_smoke, _record

torch.set_num_threads(1)

ARCH = "mamba2-130m"
ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_serve_mamba2.json")
STORED = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_mamba.npz")
TOL = dict(rtol=1e-5, atol=1e-5)
LENGTHS = (1, 2, 16, 32)
SLOTS, MAX_LEN, PROMPT = 2, 24, 9

CFG = configs.get_reduced(ARCH)
JCFG = jconfigs.get_reduced(ARCH)
# the JAX model and its entry points, jitted once for the shapes every
# test below uses: prompts of PROMPT tokens prefilled into one lane,
# decode over SLOTS lanes
JL = JLM(JCFG)
_OPT0 = {"xla_backend_optimization_level": 0}
j_prefill = jax.jit(JL.prefill, compiler_options=_OPT0)
j_decode = jax.jit(JL.decode_step, compiler_options=_OPT0)


def _close(got, want, scaled=False):
    want = np.asarray(want)
    atol = TOL["atol"] * (max(1.0, np.abs(want).max()) if scaled else 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"],
                               atol=atol)


def _cache_zeros(model, slots):
    return module.zeros(model.init_cache_specs(slots, MAX_LEN), "cpu")


def _j_zeros(slots):
    return jax.tree.map(lambda s: jnp.asarray(np.zeros(s.shape, s.dtype)),
                        JL.init_cache_specs(slots, MAX_LEN),
                        is_leaf=lambda x: isinstance(x, jmodule.ParamSpec))


# --------------------------------------------------------------- the mixer
def _j_mixer(params, xs, x_new):
    """The JAX mixer at the length of each x: the prefill with its
    cache, then one decode step from that cache."""
    out = {}
    for x, xn in zip(xs, x_new):
        y, cache = jmb.mamba(params, x, JCFG, return_cache=True)
        yd, cd = jmb.mamba_decode(params, cache, xn, JCFG)
        out[str(x.shape[1])] = {"y": y, "cache": cache, "yd": yd, "cd": cd}
    return out


def _mixer_inputs():
    """The mixer's weights (numpy, JAX layout) and, for each of LENGTHS,
    a prompt [2, L, d] and the next token's activations [2, 1, d]."""
    tree = module.init(mb.mamba_specs(CFG), 3)
    rng = np.random.RandomState(4)
    xs = [rng.randn(2, L, CFG.d_model).astype(np.float32) for L in LENGTHS]
    x_new = [rng.randn(2, 1, CFG.d_model).astype(np.float32)
             for _ in LENGTHS]
    return tree, xs, x_new


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def mixer():
    """The JAX mixer's outputs at every length, as stored in
    reference_mamba.npz (compiling them costs ~8 s on one core; one
    length is recomputed live below)."""
    tree, xs, x_new = _mixer_inputs()
    with np.load(STORED) as f:
        want = dict(f)
    p = {k: torch.from_numpy(v) for k, v in tree.items()}
    return p, tree, xs, x_new, want


def write_references(path=STORED):
    tree, xs, x_new = _mixer_inputs()
    out = jax.jit(_j_mixer)(jax.tree.map(jnp.asarray, tree), xs, x_new)
    np.savez_compressed(path, **_flat(out))
    print(f"wrote {path}")


def test_stored_references_match_live(mixer):
    """The stored mixer references against the JAX package now, at
    L = 2 (its conv tails padded), compiled at XLA's lowest backend
    optimisation level (the same function, half the compile time): to
    rtol = atol = 1e-6 of each array's largest magnitude."""
    _, tree, xs, x_new, want = mixer
    i = LENGTHS.index(2)
    live = jax.jit(_j_mixer, compiler_options=_OPT0)(
        jax.tree.map(jnp.asarray, tree), [xs[i]], [x_new[i]])
    live = _flat(live)
    assert set(live) == {k for k in want if k.startswith("2/")}
    for k, v in live.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-6,
                                   atol=1e-6 * max(1.0, np.abs(v).max()))


def test_mixer_specs_match_reference():
    t = mb.mamba_specs(CFG)
    j = jmb.mamba_specs(JCFG)
    assert set(t) == set(j)
    for k in t:
        assert (t[k].shape, t[k].axes, t[k].init, t[k].scale) == \
            (j[k].shape, j[k].axes, j[k].init, j[k].scale), k
    assert mb.mamba_cache_shapes(CFG, 3) == jmb.mamba_cache_shapes(JCFG, 3)


@pytest.mark.parametrize("L", LENGTHS)
def test_mixer_prefill_and_decode_match_reference(mixer, L):
    """The prefill's output and its four cache pieces (conv tails
    zero-padded on the left for L < 3), then a decode step from them."""
    p, _, xs, x_new, want = mixer
    i = LENGTHS.index(L)
    y, cache = mb.mamba(p, torch.from_numpy(xs[i]), CFG)
    _close(y, want[f"{L}/y"])
    assert set(cache) == {"ssm", "conv_x", "conv_B", "conv_C"}
    for k in cache:
        assert cache[k].shape == want[f"{L}/cache/{k}"].shape
        _close(cache[k], want[f"{L}/cache/{k}"], scaled=True)
    if L < 3:
        assert not cache["conv_x"][:, :3 - L].any()
    yd, cd = mb.mamba_decode(p, cache, torch.from_numpy(x_new[i]), CFG)
    _close(yd, want[f"{L}/yd"])
    for k in cd:
        _close(cd[k], want[f"{L}/cd/{k}"], scaled=True)
        assert cd[k].dtype == cache[k].dtype


def test_mixer_chunk_contract_raises(mixer):
    """L = 40 at chunk 16: the JAX package's ssd_chunked asserts; the
    port's prefill raises the same error (L = 48 passes)."""
    p = mixer[0]
    x = torch.from_numpy(np.random.RandomState(5).randn(
        1, 40, CFG.d_model).astype(np.float32))
    with pytest.raises(AssertionError):
        mb.mamba(p, x, CFG)
    y, _ = mb.mamba(p, torch.cat([x, x[:, :8]], dim=1), CFG)
    assert y.shape == (1, 48, CFG.d_model)


def test_mixer_softplus_has_no_threshold():
    """dt goes through logaddexp(x, 0), as jax.nn.softplus does, not
    torch's softplus, which returns x itself above 20."""
    x = torch.tensor([-30.0, 0.0, 19.5, 20.5, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(mb._softplus(x).numpy(), want, rtol=1e-7)


# ------------------------------------------------------------------ the LM
@pytest.fixture(scope="module")
def pair():
    model = load_model(CFG, seed=1, device="cpu")
    tree = module.init(model.param_specs(), 1)
    return model, tree, jax.tree.map(jnp.asarray, tree)


def test_lm_prefill_and_decode_match_reference(pair):
    """Two prompts, each prefilled into its own lane of a 2-slot cache
    (as the engine admits), then three decode steps over both lanes:
    logits and every cache leaf."""
    model, _, jp = pair
    tc = _cache_zeros(model, SLOTS)
    rng = np.random.RandomState(0)
    jlanes = []
    for slot in range(SLOTS):
        prompt = rng.randint(2, CFG.vocab, (1, PROMPT))
        lane = module.tree_map(lambda c: c[:, slot:slot + 1], tc)
        tlog, _, _ = model.prefill({}, lane, torch.as_tensor(prompt))
        jlog, _, jlane = j_prefill(jp, {}, _j_zeros(1), jnp.asarray(prompt))
        jlanes.append(jlane)
        _close(tlog, jlog)
    jc = jax.tree.map(lambda *c: jnp.asarray(np.concatenate(c, axis=1)),
                      *jlanes)
    pos = np.array([PROMPT, PROMPT], np.int32)
    for _ in range(3):
        tk = rng.randint(2, CFG.vocab, (SLOTS, 1))
        tlog, _, tc = model.decode_step({}, tc, torch.as_tensor(tk),
                                        torch.as_tensor(pos))
        jlog, _, jc = j_decode(jp, {}, jc, jnp.asarray(tk), jnp.asarray(pos))
        _close(tlog, jlog)
        pos = pos + 1
    assert set(tc["slot_00"]) == {"ssm", "conv_x", "conv_B", "conv_C"}
    for k, v in tc["slot_00"].items():
        assert v.shape == jc["slot_00"][k].shape
        _close(v, jc["slot_00"][k], scaled=True)


def test_lm_cache_specs_and_weights(pair):
    """The cache layout is the JAX package's ([G, B, ...]: state float32,
    conv tails in the cache dtype), the weight tree converts leaf for
    leaf with no reshapes, A_log / D / dt_bias stay float32 and the
    projections and conv weights take the compute dtype."""
    model, tree, _ = pair
    tspecs = model.init_cache_specs(3, MAX_LEN)
    jspecs = JL.init_cache_specs(3, MAX_LEN)
    for k, s in tspecs["slot_00"].items():
        assert s.shape == jspecs["slot_00"][k].shape, k
        assert s.axes == jspecs["slot_00"][k].axes, k
    assert tspecs["slot_00"]["ssm"].dtype == torch.float32
    sd = lm_params_from_numpy(CFG, tree, "cpu")
    for name, a in tree["blocks"]["slot_00"]["mixer"].items():
        for g in range(CFG.n_layers):
            np.testing.assert_array_equal(sd[f"layers.{g}.{name}"].numpy(),
                                          a[g])
    bf = build_model(configs.get_config(ARCH), device="meta")
    layer = bf.layers[0]
    for name in ("A_log", "D", "dt_bias", "norm", "ln1"):
        assert layer[name].dtype == torch.float32, name
    for name in mb.COMPUTE_DTYPE_LEAVES:
        assert layer[name].dtype == torch.bfloat16, name
    assert len(bf.layers) == 24 and "wq" not in layer


# ------------------------------------------------------------- the engines
@pytest.fixture(scope="module")
def served(pair):
    """5 requests on 2 slots through both engines, same weights, prompts
    of PROMPT tokens (the JAX prefill compiles once); slots are reused
    as requests finish, and idle lanes decode garbage in lock-step.
    The JAX engine's prefill and decode are the jitted functions above."""
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
    jeng = JServingEngine(JL, jp, JServeConfig(**scfg))
    jlog = _record(jeng, prefill=j_prefill, decode=j_decode)
    jreqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    return treqs, jreqs, tlog, jlog


def test_engine_matches_reference(served):
    treqs, jreqs, tlog, jlog = served
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert [rid for rid, _ in tlog] == [rid for rid, _ in jlog]
    for (_, t), (_, j) in zip(tlog, jlog):
        np.testing.assert_allclose(t, j, **TOL)


def test_reused_slot_serves_as_fresh(pair):
    """A request admitted into a lane that served another request, and
    then decoded garbage while idle, gets the tokens of its solo run,
    and its prefill overwrites all four leaves of that lane."""
    model, _, _ = pair
    scfg = ServeConfig(max_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=4,
                       eos_id=-1)
    rng = np.random.RandomState(6)
    a, b, c = (rng.randint(2, CFG.vocab, size=PROMPT).astype(np.int32)
               for _ in range(3))
    solo = Request(0, c)
    ServingEngine(model, scfg).run([solo])
    eng = ServingEngine(model, scfg)
    first, other, reused = Request(1, a), Request(2, b), Request(3, c)
    assert eng.admit(first) and eng.active[0] is first
    eng.step()
    eng.step()
    assert eng.admit(other) and eng.active[1] is other
    eng.step()
    eng.step()                        # first's 4th decode token: done
    assert first.done and eng.active[0] is None
    eng.step()                        # lane 0 decodes garbage while idle
    assert eng.admit(reused) and eng.active[0] is reused
    fresh = _cache_zeros(model, 1)
    model.prefill({}, fresh, torch.as_tensor(c[None].astype(np.int64)))
    for k, v in eng.cache["slot_00"].items():
        assert torch.equal(v[:, 0:1], fresh["slot_00"][k]), k
    eng.run([])
    assert reused.out == solo.out and other.done and len(solo.out) == 5


def test_serve_launcher_runs_on_cpu(capsys):
    assert serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "2", "--slots", "2", "--max-len",
                       "32"]) == 0
    assert "served 3 requests" in capsys.readouterr().out


# ------------------------------------------------------ chip_smoke.py's
def test_chip_smoke_witness_is_ssd_sequential():
    """The witness of chip_smoke.py's bfloat16 Mamba2 serve routes the
    plain SSD (`impl="ref"`) to `ssd_sequential` and gives the chunked
    form back on exit; the two agree to float32 rounding (1e-4)."""
    from repro_torch.kernels import ref
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.randn(1, 32, 3, 4), dtype=torch.float32)
    dt = torch.tensor(np.log1p(np.exp(rng.randn(1, 32, 3))),
                      dtype=torch.float32)
    A = -torch.tensor(np.exp(rng.randn(3)), dtype=torch.float32)
    Bm, Cm = (torch.tensor(rng.randn(1, 32, 5), dtype=torch.float32)
              for _ in range(2))
    plain = ref.ssd_scan_ref
    with _chip_smoke().sequential_ssd(torch):
        y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16, impl="ref")
    assert ref.ssd_scan_ref is plain
    ys, ss = ssd_sequential(x, dt, A, Bm, Cm)
    assert torch.equal(y, ys) and torch.equal(s, ss)
    yc, sc = ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    np.testing.assert_allclose(y.numpy(), yc.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), sc.numpy(), rtol=1e-4, atol=1e-4)


def test_golden_is_well_formed_and_matches_chip_smoke():
    with open(GOLDEN) as f:
        g = json.load(f)
    smoke = _chip_smoke()
    assert g["arch"] == smoke.MAMBA_ARCH == ARCH
    assert g["seed"] == smoke.SERVE_SEED
    assert g["serve"] == smoke.SERVE_CONFIG
    assert g["dtype"] == "float32"
    cfg = configs.get_config(ARCH)
    assert g["config"] == {k: getattr(cfg, k) for k in g["config"]}
    assert g["config"]["n_layers"] == 24 and g["config"]["d_model"] == 768
    reqs = g["requests"]
    assert len(reqs) == smoke.MAMBA_REQUESTS > g["serve"]["max_slots"]
    lens = [len(r["prompt"]) for r in reqs]
    assert lens.count(512) == 2
    assert all(16 <= n <= 256 for n in lens if n != 512)
    # a 512-token prompt lands in a reused slot (index >= max_slots)
    assert any(n == 512 for n in lens[g["serve"]["max_slots"]:])
    for r in reqs:
        n = len(r["tokens"])
        assert 1 <= n <= g["serve"]["max_new_tokens"] + 1
        assert len(r["top5_values"]) == len(r["top5_indices"]) == n
        assert len(r["top2_margin"]) == n
        for vals, idx, tok, margin in zip(r["top5_values"],
                                          r["top5_indices"], r["tokens"],
                                          r["top2_margin"]):
            assert idx[0] == tok and len(vals) == len(idx) == 5
            assert vals == sorted(vals, reverse=True)
            assert margin == pytest.approx(vals[0] - vals[1])
        if n < g["serve"]["max_new_tokens"] + 1:
            assert r["tokens"][-1] == g["serve"]["eos_id"]


# ------------------------------------------------------------- the golden
def golden_requests(seed: int, n: int, vocab: int) -> list:
    """chip_smoke.py's Mamba2 serving requests: prompt lengths from
    RandomState(seed).randint(16, 257), those of requests 0 and 9
    pinned to 512 (two chunks of 256; request 9 is admitted into a
    reused slot), then the tokens."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(16, 257, size=n)
    lens[0] = lens[9] = 512
    return [rng.randint(2, vocab, size=int(L)).astype(np.int32)
            for L in lens]


def write_golden(path=GOLDEN):
    smoke = _chip_smoke()
    seed, scfg = smoke.SERVE_SEED, smoke.SERVE_CONFIG
    cfg = jconfigs.get_config(smoke.MAMBA_ARCH).replace(
        compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    tcfg = configs.get_config(smoke.MAMBA_ARCH)
    t0 = time.perf_counter()
    jmodel = JLM(cfg)
    from repro_torch.models.lm import LM
    tree = module.init(LM(tcfg, device="meta").param_specs(), seed)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    print(f"weights: {time.perf_counter() - t0:.1f} s", flush=True)
    engine = JServingEngine(jmodel, params, JServeConfig(**scfg))
    log = _record(engine)
    prompts = golden_requests(seed, smoke.MAMBA_REQUESTS, cfg.vocab)
    reqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    engine.run(reqs)
    rows = {r.rid: [] for r in reqs}
    for rid, row in log:
        rows[rid].append(row)
    out = {"arch": smoke.MAMBA_ARCH, "seed": seed, "serve": scfg,
           "dtype": "float32",
           "config": {k: getattr(tcfg, k) for k in (
               "n_layers", "d_model", "vocab", "ssm_state", "ssm_head_dim",
               "ssm_expand", "ssm_chunk", "norm_eps", "tie_embeddings")},
           "jax": jax.__version__, "requests": []}
    for r in reqs:
        top_i = [np.argsort(-row, kind="stable")[:5] for row in rows[r.rid]]
        top_v = [row[i] for row, i in zip(rows[r.rid], top_i)]
        out["requests"].append({
            "rid": r.rid, "prompt": [int(t) for t in r.prompt],
            "tokens": [int(t) for t in r.out],
            "top5_indices": [[int(j) for j in i] for i in top_i],
            "top5_values": [[float(x) for x in v] for v in top_v],
            "top2_margin": [float(v[0] - v[1]) for v in top_v]})
        print(r.rid, len(r.prompt), r.out[:6], flush=True)
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {path} in {time.perf_counter() - t0:.1f} s", flush=True)


def float32_witness():
    """The port's float32 prefill at full mamba2-130m width on the CPU
    (the plain SSD) against the golden, beside chip_smoke.py's float32
    witness (one ulp of change in the embedding table): the largest
    relative gap of the top-5 logits for each request."""
    smoke = _chip_smoke()
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg = configs.get_config(ARCH).replace(compute_dtype=torch.float32,
                                           cache_dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    tree = module.init(model.param_specs(), g["seed"])
    model.load_state_dict(lm_params_from_numpy(cfg, tree, "cpu"))
    for r in g["requests"]:
        prompt = torch.as_tensor([r["prompt"]])
        cache = module.zeros(model.init_cache_specs(1, prompt.shape[1]),
                             "cpu")
        got = model.prefill({}, cache, prompt)[0][0, r["top5_indices"][0]]
        want = torch.tensor(r["top5_values"][0])
        gap = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        one = smoke.one_ulp_shift(torch, model, {"requests": [r]})
        print(f"request {r['rid']} (L={len(r['prompt'])}): prefill gap "
              f"{gap:.3g}, one-ulp witness {one:.3g}", flush=True)


if __name__ == "__main__":
    if "--float32-witness" in sys.argv[1:]:
        float32_witness()
    if "--write-references" in sys.argv[1:]:
        write_references()
    if "--write-golden" in sys.argv[1:]:
        write_golden()
