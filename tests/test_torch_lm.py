"""The port's dense LM (`repro_torch.models`) against the JAX package's
`repro.models.LM` at the reduced Qwen3-0.6B config (2 layers, d 64,
4 heads, 2 KV heads, hd 16, vocab 256, float32), fed the same numpy
weights: `models.module.init` draws the JAX layout tree, the JAX model
takes it as is and the port through `convert.lm_params_from_numpy`.

Tolerances: logits rtol = atol = 1e-5 (measured: below 5e-7), caches
rtol 1e-5 with atol 1e-5 of their largest magnitude.  Every
architecture's configuration copies over field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import LM as JLM
from repro.models import module as jmodule
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import load_model
from repro_torch.models import build_model, module

torch.set_num_threads(1)

ARCH = "qwen3-0.6b"
LOGITS = dict(rtol=1e-5, atol=1e-5)


def _cache_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# the JAX model and its jitted entry points, shared with
# test_torch_serving.py (its engine runs on the same shapes: 2 slots of
# 24 positions, prompts of 9 tokens prefilled one slot at a time)
JL = JLM(jconfigs.get_reduced(ARCH))
j_prefill = jax.jit(JL.prefill)
j_decode = jax.jit(JL.decode_step)
SLOTS, MAX_LEN, PROMPT = 2, 24, 9


@pytest.fixture(scope="module")
def pair():
    cfg = configs.get_reduced(ARCH)
    model = load_model(cfg, seed=1, device="cpu")
    tree = module.init(model.param_specs(), 1)
    return cfg, model, tree, jax.tree.map(jnp.asarray, tree)


def test_prefill_and_decode_match_reference(pair):
    """Two prompts, each prefilled into its own slot of a 2-slot cache
    (as the engine admits), then three decode steps over both slots at
    different positions (slot 1 decodes over the tail of its prompt):
    logits and caches."""
    cfg, model, _, jp = pair
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
    for name in ("k", "v"):
        _cache_close(tc["slot_00"][name], jc["slot_00"][name])
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


def test_weight_converter_layout(pair):
    """wq [d, H, hd] flattens row-major, so x @ wq is the reference's
    einsum; layer g of the stack is layer g; a tree that does not match
    the model is refused."""
    cfg, model, tree, _ = pair
    sd = lm_params_from_numpy(cfg, tree, "cpu")
    mixer = tree["blocks"]["slot_00"]["mixer"]
    x = np.random.RandomState(2).standard_normal((3, cfg.d_model))
    x = x.astype(np.float32)
    for g in range(cfg.n_layers):
        want = np.einsum("ld,dhk->lhk", x, mixer["wq"][g])
        got = (torch.from_numpy(x) @ sd[f"layers.{g}.wq"]).numpy()
        np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(
            sd[f"layers.{g}.wo"].numpy(),
            mixer["wo"][g].reshape(cfg.n_heads * cfg.hd, cfg.d_model))
        np.testing.assert_array_equal(
            sd[f"layers.{g}.wd"].numpy(),
            tree["blocks"]["slot_00"]["ffn"]["wd"][g])
    assert set(sd) == set(model.state_dict())
    bad = dict(tree, blocks={"slot_00": dict(tree["blocks"]["slot_00"])})
    del bad["blocks"]["slot_00"]["ln2"]
    with pytest.raises((KeyError, ValueError)):
        lm_params_from_numpy(cfg, bad, "cpu")


def test_numpy_init_rules_and_determinism(pair):
    cfg, model, tree, _ = pair
    specs = model.param_specs()
    jspecs = JL.param_specs()
    flat = dict(module.leaves(tree))
    jflat = {tuple(getattr(k, "key", k) for k in path): s for path, s in
             jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(x, jmodule.ParamSpec)
             )[0]}
    assert set(flat) == set(jflat)
    for path, s in module.leaves(specs):
        assert flat[path].shape == s.shape == jflat[path].shape
        assert flat[path].dtype == np.float32
    assert module.param_count(specs) == jmodule.param_count(jspecs)
    assert (flat[("final_norm",)] == 1).all()
    assert (flat[("blocks", "slot_00", "ln1")] == 1).all()
    assert abs(flat[("embed",)].std() - 0.02) < 2e-3
    # fan_in over the leading (layers) axis, as the JAX package draws it
    wg = flat[("blocks", "slot_00", "ffn", "wg")]
    assert abs(wg.std() * np.sqrt(cfg.n_layers) - 1.0) < 0.05
    again = dict(module.leaves(module.init(specs, 1)))
    other = dict(module.leaves(module.init(specs, 2)))
    for path in flat:
        np.testing.assert_array_equal(again[path], flat[path])
    assert not np.array_equal(other[("embed",)], flat[("embed",)])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_copy_over(arch):
    """Every field of every architecture's config equals the JAX
    package's (dtypes by name)."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for get in ("get_config", "get_reduced"):
        t = getattr(configs, get)(arch)
        j = getattr(jconfigs, get)(arch)
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(a, torch.dtype):
                assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
            else:
                assert a == b, (arch, get, f.name)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_family_builds(arch):
    """Every architecture of the registry builds at full width (on the
    meta device): an `EncDecLM` for the encoder-decoder family, else an
    `LM`, with the parameter count of the JAX package's model."""
    from repro.models import build_model as j_build_model
    from repro_torch.models import EncDecLM, LM
    cfg = configs.get_config(arch)
    model = build_model(cfg, device="meta")
    assert isinstance(model, EncDecLM if cfg.family == "encdec" else LM)
    specs = model.param_specs()
    n = sum(t.numel() for t in model.state_dict().values())
    assert n == module.param_count(specs) == jmodule.param_count(
        j_build_model(jconfigs.get_config(arch)).param_specs())


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b"])
def test_moe_families_build(arch):
    """The MoE FFN is ported: the MoE and hybrid configs build at full
    width (on the meta device) with the parameter count and the state
    specs of the JAX package, the router float32 and the experts in the
    compute dtype."""
    cfg = configs.get_config(arch)
    model = build_model(cfg, device="meta")
    jl = JLM(jconfigs.get_config(arch))
    n = sum(t.numel() for t in model.state_dict().values())
    assert n == module.param_count(model.param_specs()) \
        == jmodule.param_count(jl.param_specs())
    moe = [p for p in model.layers if "router" in p]
    assert len(moe) == sum(f == "moe" for _, f in cfg.layer_pattern()) > 0
    assert all(p["router"].dtype == torch.float32
               and p["wg"].dtype == cfg.compute_dtype for p in moe)
    jstate = jl.state_specs()
    for (path, s), (jpath, js) in zip(
            module.leaves(model.state_specs()),
            jax.tree_util.tree_flatten_with_path(
                jstate, is_leaf=lambda x: isinstance(x,
                                                     jmodule.ParamSpec))[0]):
        assert path == tuple(getattr(k, "key", k) for k in jpath)
        assert (s.shape, s.axes, s.init) == (js.shape, js.axes, js.init)


@pytest.mark.parametrize("get", ["get_reduced", "get_config"])
def test_mamba2_builds(get):
    """The SSM family is ported: mamba2-130m builds, reduced and at full
    width (on the meta device), with one Mamba mixer a layer and the
    parameter count of the JAX package's specs."""
    cfg = getattr(configs, get)("mamba2-130m")
    model = build_model(cfg, device="meta" if get == "get_config" else "cpu")
    assert len(model.layers) == cfg.n_layers
    assert all("A_log" in p and "wq" not in p for p in model.layers)
    n = sum(t.numel() for t in model.state_dict().values())
    assert n == module.param_count(model.param_specs())
    if get == "get_config":
        assert n == jmodule.param_count(JLM(jconfigs.get_config(
            "mamba2-130m")).param_specs())
