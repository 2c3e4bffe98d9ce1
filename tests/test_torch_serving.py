"""The port's serving engine against the JAX package's.

At the reduced Qwen3-0.6B config (2 layers, d 64, f32) the same numpy
weights and the same 5 requests on 2 slots give the same tokens through
`repro_torch.serving.ServingEngine` and `repro.serving.ServingEngine`,
and the logits behind every token agree to rtol = atol = 1e-5.  The
engine's completion rules (the decode budget, an EOS from prefill,
max_len) are mirrored on a stub model, and the stored full-width golden
that `chip_smoke.py` holds the card's run against is checked for form.

Run as a script, this file writes that golden:

    PYTHONPATH=src python tests/test_torch_serving.py --write-golden

the JAX `ServingEngine` on the CPU at full Qwen3-0.6B width in float32,
weights from the port's `models.module.init` (numpy), the requests of
`chip_smoke.py`'s serving phase; it records each request's tokens and,
for every token, the top-5 logits and the top-2 margin.
"""
import importlib.util
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
from repro.models import build_model as j_build_model
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.launch.serve import load_model, main as serve_main
from repro_torch.models import module
from repro_torch.serving import Request, ServeConfig, ServingEngine
from test_torch_lm import JL, MAX_LEN, PROMPT, SLOTS, j_decode, j_prefill

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_serve.json")
ARCH = "qwen3-0.6b"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------- engine vs the reference
@pytest.fixture(scope="module")
def served():
    """5 requests on 2 slots through both engines, same weights (prompts
    of one length, so the JAX prefill compiles once; the slots still
    decode at different positions, as requests start at different
    steps).  The JAX
    engine runs its own admit / step / run; its model's prefill and
    decode are the jitted functions test_torch_lm.py compiles for these
    shapes (the engine itself calls prefill eagerly and jits decode).
    Each engine's logits rows are gathered from outside it: the port's
    by `chip_smoke.watch_tokens`, the JAX one's by `_record`."""
    cfg = configs.get_reduced(ARCH)
    model = load_model(cfg, seed=0, device="cpu")
    tree = module.init(model.param_specs(), 0)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, cfg.vocab, size=PROMPT).astype(np.int32)
               for _ in range(5)]
    scfg = dict(max_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=6)
    tlog = []
    tengine = ServingEngine(model, ServeConfig(**scfg))
    _chip_smoke().watch_tokens(tengine, lambda r, row: tlog.append(
        (r.rid, row.numpy().copy())))
    treqs = [Request(i, p) for i, p in enumerate(prompts)]
    tengine.run(treqs)
    jengine = JServingEngine(JL, jax.tree.map(jnp.asarray, tree),
                             JServeConfig(**scfg))
    jlog = _record(jengine, prefill=j_prefill, decode=j_decode)
    jreqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    jengine.run(jreqs)
    return treqs, jreqs, tlog, jlog


def test_engine_matches_reference(served):
    treqs, jreqs, tlog, jlog = served
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert [rid for rid, _ in tlog] == [rid for rid, _ in jlog]
    for (_, t), (_, j) in zip(tlog, jlog):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_engine_output_lengths_on_the_model(served):
    """Decode budget 6 and max_len 24: every request that never meets
    EOS ends with exactly 7 tokens."""
    treqs, _, _, _ = served
    for r in treqs:
        if 1 in r.out:                        # EOS id
            assert r.out.index(1) == len(r.out) - 1
        else:
            assert len(r.out) == min(7, 24 - 1 - len(r.prompt) + 1)


# ---------------------------------------------------------------- the stub
class TinyLM:
    """Serving stub: next token = (last + acc) % vocab, where `acc` is a
    per-slot accumulator kept in the cache (prefill sets it to Σprompt,
    decode adds the fed token): the rule of the JAX package's
    `tests/test_serving.py` stub, with the accumulator in the cache
    instead of the model state."""

    def __init__(self, vocab: int = 13):
        self.vocab = vocab
        self.device = torch.device("cpu")

    def init_cache_specs(self, batch, max_len):
        return {"acc": module.ParamSpec((1, batch, 1), ("layers", "batch",
                                                        "d"),
                                        torch.int64, "zeros")}

    def _onehot(self, nxt):
        return torch.nn.functional.one_hot(nxt, self.vocab).float()

    def prefill(self, state, cache, prompt):
        cache["acc"][0, :, 0] = prompt.sum()
        nxt = (prompt[:, -1] + cache["acc"][0, :, 0]) % self.vocab
        return self._onehot(nxt), state, cache

    def decode_step(self, state, cache, toks, pos):
        cache["acc"][0, :, 0] += toks[:, 0]
        nxt = (toks[:, 0] + cache["acc"][0, :, 0]) % self.vocab
        return self._onehot(nxt), state, cache


def _tiny_engine(slots=3, max_new=6, eos=99, vocab=13, max_len=32):
    return ServingEngine(TinyLM(vocab), ServeConfig(
        max_slots=slots, max_len=max_len, eos_id=eos,
        max_new_tokens=max_new))


def _req(rid, toks):
    return Request(rid=rid, prompt=np.asarray(toks, np.int32))


def test_engine_exact_output_lengths():
    """max_new_tokens budgets DECODE steps: out = prefill token + exactly
    max_new_tokens decode tokens when neither EOS nor max_len triggers."""
    eng = _tiny_engine(slots=2, max_new=5, eos=99)   # eos unreachable
    reqs = [_req(0, [3, 4]), _req(1, [2, 7, 5])]
    eng.run(reqs, max_steps=50)
    assert all(r.done for r in reqs)
    assert [len(r.out) for r in reqs] == [6, 6]


def test_engine_prefill_eos_completes_immediately():
    """A prefill-emitted EOS ends the request at admission: out is the
    single EOS token and the slot is free."""
    eng = _tiny_engine(slots=1, max_new=8, eos=0, vocab=5)
    r = _req(0, [0])        # Σprompt=0 → prefill token (0+0)%5 = 0 = EOS
    assert eng.admit(r)
    assert r.done and r.out == [0]
    assert eng.active == [None]           # slot never occupied
    r2 = _req(1, [2])       # prefill 4; decode: acc 2+4=6 → (4+6)%5 = 0
    eng.run([r2], max_steps=20)
    assert r2.done and r2.out == [4, 0] and len(r2.out) < 8 + 1


def test_engine_admit_step_run_basic():
    """More requests than slots drain through freed slots."""
    eng = _tiny_engine(slots=2, max_new=3, eos=99)
    reqs = [_req(i, [2 + i, 3]) for i in range(5)]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)
    assert all(0 <= t < 13 for r in reqs for t in r.out)


def test_engine_slot_isolation():
    """Admitting a request mid-flight writes only its own cache lane: the
    first request's tokens equal its solo run."""
    solo = _req(0, [3, 4, 5])
    _tiny_engine(slots=2, max_new=6).run([solo], max_steps=50)
    eng = _tiny_engine(slots=2, max_new=6)
    a, b = _req(0, [3, 4, 5]), _req(1, [9, 11])
    assert eng.admit(a)
    eng.step()
    eng.step()
    assert eng.admit(b)
    eng.run([], max_steps=50)
    assert a.done and b.done and a.out == solo.out


def test_max_len_ends_request():
    """A request ends when its position reaches max_len - 1."""
    eng = _tiny_engine(slots=1, max_new=50, eos=99, max_len=8)
    r = _req(0, [1, 2, 3])
    eng.run([r], max_steps=50)
    assert r.done and len(r.out) == 1 + (8 - 1 - 3)


def test_serve_launcher_runs_on_cpu(capsys):
    assert serve_main(["--device", "cpu", "--requests", "3",
                       "--max-new", "2", "--slots", "2", "--max-len",
                       "32"]) == 0
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


# ------------------------------------------------------------- the golden
def test_golden_is_well_formed_and_matches_chip_smoke():
    with open(GOLDEN) as f:
        g = json.load(f)
    smoke = _chip_smoke()
    assert g["arch"] == smoke.SERVE_ARCH == ARCH
    assert g["seed"] == smoke.SERVE_SEED
    assert g["serve"] == smoke.SERVE_CONFIG
    assert g["dtype"] == "float32"
    cfg = configs.get_config(ARCH)
    assert g["config"] == {k: getattr(cfg, k) for k in g["config"]}
    assert g["config"]["n_layers"] == 28 and g["config"]["d_model"] == 1024
    reqs = g["requests"]
    assert len(reqs) == smoke.SERVE_REQUESTS > g["serve"]["max_slots"]
    lens = [len(r["prompt"]) for r in reqs]
    assert max(lens) == 512 and any(n % 64 for n in lens)
    assert all(16 <= n <= 512 for n in lens)
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


def test_chip_smoke_witness_is_the_plain_attention():
    """The witness of chip_smoke.py's bfloat16 serve, the plain attention
    with the keys in reverse order, computes the plain attention (f32:
    to rounding, 1e-6) and gives the plain version back on exit."""
    from repro_torch.kernels import ops, ref
    rng = np.random.RandomState(3)

    def t(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    q, k, v = t(1, 4, 37, 16), t(1, 2, 37, 16), t(1, 2, 37, 16)
    qd, kc, vc = t(3, 2, 2, 16), t(3, 20, 2, 16), t(3, 20, 2, 16)
    lengths = torch.tensor([1, 20, 7], dtype=torch.int32)
    plain = (ref.flash_attention_ref, ref.decode_attention_ref)
    with _chip_smoke().reversed_keys(torch):
        got = (ops.flash_attention(q, k, v, causal=True, impl="ref"),
               ops.flash_attention(q, k, v, causal=False, impl="ref"),
               ops.decode_attention(qd, kc, vc, lengths, impl="ref"))
    assert (ref.flash_attention_ref, ref.decode_attention_ref) == plain
    want = (ref.flash_attention_ref(q, k, v, causal=True),
            ref.flash_attention_ref(q, k, v, causal=False),
            ref.decode_attention_ref(qd, kc, vc, lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def golden_requests(seed: int, n: int, vocab: int) -> list:
    """chip_smoke.py's serving requests: prompt lengths from
    RandomState(seed).randint(16, 513), the first pinned to 512 and the
    second to 333 (not a multiple of 64), then the tokens."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(16, 513, size=n)
    lens[0], lens[1] = 512, 333
    return [rng.randint(2, vocab, size=int(L)).astype(np.int32)
            for L in lens]


def _record(engine, prefill=None, decode=None):
    """Route the logits row behind every token the JAX engine emits to a
    list of (rid, row), without touching the engine's code.  `prefill`
    and `decode` replace the model's functions (same signatures)."""
    log, last = [], {}
    model = engine.model
    prefill_fn = model.prefill if prefill is None else prefill

    class Proxy:
        cfg = model.cfg
        init_cache_specs = model.init_cache_specs
        state_specs = model.state_specs

        @staticmethod
        def prefill(*args):
            out = prefill_fn(*args)
            last["logits"] = np.asarray(out[0])
            return out

    engine.model = Proxy
    decode = engine._decode if decode is None else decode

    def rec_decode(*args):
        out = decode(*args)
        last["logits"] = np.asarray(out[0])
        return out

    engine._decode = rec_decode
    admit, step = engine.admit, engine.step

    def rec_admit(req):
        ok = admit(req)
        if ok:
            log.append((req.rid, last["logits"][0]))
        return ok

    def rec_step():
        before = list(engine.active)
        last.pop("logits", None)
        step()
        if "logits" in last:
            log.extend((r.rid, last["logits"][i])
                       for i, r in enumerate(before) if r is not None)

    engine.admit, engine.step = rec_admit, rec_step
    return log


def write_golden(path=GOLDEN):
    smoke = _chip_smoke()
    seed, scfg = smoke.SERVE_SEED, smoke.SERVE_CONFIG
    cfg = jconfigs.get_config(smoke.SERVE_ARCH).replace(
        compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    tcfg = configs.get_config(smoke.SERVE_ARCH)
    t0 = time.perf_counter()
    jmodel = j_build_model(cfg)
    from repro_torch.models.lm import LM
    tree = module.init(LM(tcfg, device="meta").param_specs(), seed)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    print(f"weights: {time.perf_counter() - t0:.1f} s", flush=True)
    engine = JServingEngine(jmodel, params, JServeConfig(**scfg))
    log = _record(engine)
    prompts = golden_requests(seed, smoke.SERVE_REQUESTS, cfg.vocab)
    reqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    engine.run(reqs)
    rows = {r.rid: [] for r in reqs}
    for rid, row in log:
        rows[rid].append(row)
    out = {"arch": smoke.SERVE_ARCH, "seed": seed, "serve": scfg,
           "dtype": "float32",
           "config": {k: getattr(tcfg, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab", "qk_norm", "rope_theta", "norm_eps",
               "tie_embeddings")},
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


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
