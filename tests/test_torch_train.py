"""The port's training stack against the JAX package's, on the CPU:

* `optim`: `schedule`, `adamw_update`, `global_norm` and `compress_int8`
  against `repro.optim` on the same trees (rtol 1e-6; the int8
  compression bit for bit: both divide, round half to even and
  multiply the same float32 values);
* `data.packed_batches`, `microbatches` and `StragglerSimulator` bit for
  bit against `repro.data`;
* three steps of `train.build_train_step` against the JAX train step from
  one state carried across by `convert.train_state_from_numpy`: plain
  (reduced Qwen3), `n_microbatch=2` with an `mb_mask` that drops the
  second microbatch (reduced OLMoE: the load EMAs blended by the mask),
  and `grad_compression=True` (reduced Qwen3).  Losses and gradient norms
  to rtol 1e-5, every leaf of the new state within 1e-5 of its norm in
  L2, or, where more, three times the distance by which the JAX run
  itself moves from a start one ulp up (AdamW divides by √v: where a
  gradient is rounding noise its update's sign is noise too).  Under
  compression the error state and the moments are only checked finite:
  the int8 code is discontinuous, and a gradient on a rounding boundary
  rounds either way in either package (the JAX run from one ulp up
  moves its own error state by up to 6e-2 of its norm and the moments
  by up to 7e-4); `compress_int8` itself is held bit for bit above, and
  the parameters, losses and gradient norms at the rule above;
* checkpoints: a round trip, last-k retention, a step without its DONE
  marker ignored, and a checkpoint the JAX package wrote restored into
  the port's train state;
* `launch.train.main(["--reduced", ...])` on the CPU to "done." and a
  resume from its checkpoint;
* the golden `src/repro_torch/data/reference_train.json` (the JAX train
  step at Qwen3-0.6B's full width, 4 of 28 layers, float32, batch 2 x
  128, 3 steps) well formed and on `chip_smoke.py`'s train constants.

The golden is written by

    PYTHONPATH=src python tests/test_torch_train.py --write-golden

(JAX on the CPU, ~2 min, ~6 GB): the same weights drawn with
`models.module.init(param_specs, TRAIN_SEED)`, the batches of
`packed_batches`, the losses, gradient norms and learning rates of each
step, and the same from weights one ulp up (the witness of float32
rounding at this size).
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

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import data as jdata
from repro import optim as joptim
from repro import train as jtrain
from repro.models import build_model as jbuild
from repro_torch import checkpoint as ckpt
from repro_torch import configs, data, optim
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model, module
from repro_torch.train import (TrainConfig, build_train_step,
                               init_train_state, loss_and_grads)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data",
                      "reference_train.json")
# the golden's run: Qwen3-0.6B at full width, float32, TRAIN_F32_LAYERS of
# 28 layers, TRAIN_F32_STEPS steps on batches of TRAIN_F32_BATCH x
# TRAIN_F32_SEQ, AdamW at TRAIN_OPT (chip_smoke.py holds the same)
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEED = 0
TRAIN_F32_LAYERS = 4
TRAIN_F32_BATCH, TRAIN_F32_SEQ, TRAIN_F32_STEPS = 2, 128, 3
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "decay_steps": 100}
STEP_RTOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jit_o0(fn, *args):
    """fn jitted and compiled for `args` at XLA's backend optimisation
    level 0 (the same arithmetic, half the compile time on one core)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def one_ulp_up(tree):
    return jax.tree.map(lambda a: np.nextafter(a, np.inf).astype(a.dtype)
                        if np.issubdtype(a.dtype, np.floating) else a, tree)


def _rand_tree(rng, positive=False):
    def leaf(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.abs(a) if positive else a
    return {"a": leaf(3, 5), "b": {"c": leaf(7), "d": leaf(2, 3, 4)}}


# ------------------------------------------------------------------ optim
OPT = dict(lr=1e-3, warmup_steps=10, decay_steps=50, clip_norm=0.5)


@pytest.fixture(scope="module")
def optim_case():
    """Random trees, an optimizer state at step 4, and the JAX package's
    schedule, AdamW step, global norm and int8 compression of them, all
    from one jitted program."""
    rng = np.random.RandomState(0)
    jcfg = joptim.OptConfig(**OPT)
    params, grads, err = (_rand_tree(rng) for _ in range(3))
    opt = {"mu": _rand_tree(rng), "nu": _rand_tree(rng, positive=True),
           "count": np.int32(4)}
    steps = np.array([0, 1, 5, 10, 11, 30, 50, 80], np.int32)

    def jfn(params, grads, opt, err, steps):
        return (joptim.schedule(jcfg, steps),
                joptim.adamw_update(jcfg, params, grads, opt),
                joptim.global_norm(grads), joptim.compress_int8(grads, err))
    args = (params, grads, opt, err, steps)
    return args, jit_o0(jfn, *args)(*args)


def _t(tree):
    return module.tree_map(torch.as_tensor, tree)


def _leaves_close(got, want, **tol):
    for path, w in module.leaves(want):
        g = got
        for k in path:
            g = g[k]
        if tol:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=str(path), **tol)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=str(path))


def test_schedule_matches_reference(optim_case):
    (_, _, _, _, steps), (j_sched, _, _, _) = optim_case
    np.testing.assert_allclose(
        optim.schedule(optim.OptConfig(**OPT), torch.as_tensor(steps))
        .numpy(), np.asarray(j_sched), rtol=1e-6)


def test_adamw_update_matches_reference(optim_case):
    (params, grads, opt, _, _), (_, (jp, jopt, jm), _, _) = optim_case
    tp, topt, tm = optim.adamw_update(optim.OptConfig(**OPT), _t(params),
                                      _t(grads), _t(opt))
    for got, want in ((tp, jp), (topt["mu"], jopt["mu"]),
                      (topt["nu"], jopt["nu"])):
        _leaves_close(got, want, rtol=1e-6, atol=1e-9)
    assert int(topt["count"]) == int(jopt["count"]) == 5
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-6)


def test_global_norm_matches_reference(optim_case):
    (_, grads, _, _, _), (_, _, j_gn, _) = optim_case
    np.testing.assert_allclose(float(optim.global_norm(_t(grads))),
                               float(j_gn), rtol=1e-6)


def test_compress_int8_matches_reference_bitwise(optim_case):
    (_, grads, _, err, _), (_, _, _, (j_comp, j_err)) = optim_case
    comp, new_err = optim.compress_int8(_t(grads), _t(err))
    _leaves_close(comp, j_comp)
    _leaves_close(new_err, j_err)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("pack", [True, False])
def test_pipeline_matches_reference_bitwise(pack):
    kw = dict(vocab=1000, seq_len=64, global_batch=4, seed=3,
              mean_doc_len=20, pack=pack)
    ours = data.packed_batches(data.DataConfig(**kw), shard=1, num_shards=2)
    theirs = jdata.packed_batches(jdata.DataConfig(**kw), shard=1,
                                  num_shards=2)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_microbatches_match_reference():
    kw = dict(vocab=500, seq_len=32, global_batch=6, seed=4)
    a = next(data.packed_batches(data.DataConfig(**kw)))
    b = next(jdata.packed_batches(jdata.DataConfig(**kw)))
    for n in (1, 2, 3):
        ours, theirs = data.microbatches(a, n), jdata.microbatches(b, n)
        assert len(ours) == len(theirs) == n
        for ma, mb in zip(ours, theirs):
            for k in ma:
                np.testing.assert_array_equal(ma[k], mb[k])


def test_straggler_simulator_matches_reference():
    for p, seed in ((0.3, 7), (0.0, 1), (1.0, 2)):
        s, js = data.StragglerSimulator(p, seed), jdata.StragglerSimulator(
            p, seed)
        assert [s.is_late() for _ in range(64)] == [js.is_late()
                                                    for _ in range(64)]


# -------------------------------------------------------------- the step
def _leaf_close(got, want, wit, what):
    got, want, wit = (np.asarray(x, dtype=np.float64) for x in
                      (got, want, wit))
    err = float(np.linalg.norm(got - want))
    tol = max(STEP_RTOL * float(np.linalg.norm(want)),
              3 * float(np.linalg.norm(wit - want)), 1e-30)
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("case", ["plain", "microbatch_mask",
                                  "grad_compression"])
def test_train_step_matches_reference(case):
    arch = "olmoe-1b-7b" if case == "microbatch_mask" else "qwen3-0.6b"
    cfg = configs.get_reduced(arch, n_layers=1)
    jmodel = jbuild(jconfigs.get_reduced(arch, n_layers=1))
    model = build_model(cfg, device="meta")
    kw = dict(n_microbatch=2 if case == "microbatch_mask" else 1,
              grad_compression=case == "grad_compression")
    opt = dict(lr=1e-2, warmup_steps=2, decay_steps=10)
    tc = TrainConfig(opt=optim.OptConfig(**opt), **kw)
    jtc = jtrain.TrainConfig(opt=joptim.OptConfig(**opt), **kw)
    rng = np.random.RandomState(8)
    params = module.init(model.param_specs(), 8)
    mstate = module.tree_map(lambda s: rng.uniform(0, 5, s.shape).astype(
        np.float32), model.state_specs())
    st0 = train_state_to_numpy(init_train_state(
        train_state_from_numpy(params, "cpu"),
        train_state_from_numpy(mstate, "cpu"), tc))
    mask = (np.array([1.0, 0.0], np.float32) if case == "microbatch_mask"
            else None)
    batches = data.packed_batches(data.DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=4, seed=8, mean_doc_len=8))
    batches = [next(batches) for _ in range(3)]

    jstep = jit_o0(jtrain.build_train_step(jmodel, jtc), st0, batches[0],
                   mask)

    def jrun(st):
        mets = []
        for b in batches:
            st, m = jstep(st, b, mask)
            mets.append(m)
        return st, mets
    jst, jmets = jrun(st0)
    wst, wmets = jrun(one_ulp_up(st0))

    step = build_train_step(model, tc)
    st = train_state_from_numpy(st0, "cpu")
    for b, jm, wm in zip(batches, jmets, wmets):
        st, m = step(st, {k: torch.as_tensor(v) for k, v in b.items()},
                     None if mask is None else torch.as_tensor(mask))
        assert set(jm) <= set(m)
        for name in jm:
            tol = max(STEP_RTOL * abs(float(jm[name])),
                      3 * abs(float(wm[name]) - float(jm[name])))
            assert abs(float(m[name]) - float(jm[name])) <= tol, (case, name)
    got = train_state_to_numpy(st)
    for (path, w), (_, wit) in zip(module.leaves(jax.device_get(jst)),
                                   module.leaves(jax.device_get(wst))):
        g = got
        for k in path:
            g = g[k]
        if case == "grad_compression" and (
                path[0] == "err" or path[:2] in (("opt", "mu"),
                                                 ("opt", "nu"))):
            # the int8 code is discontinuous: see the module docstring
            assert g.shape == np.shape(w) and np.isfinite(g).all()
            continue
        _leaf_close(g, w, wit, (case, path))


# ------------------------------------------------------------ checkpoints
def _ckpt_tree():
    rng = np.random.RandomState(9)
    return {"params": _rand_tree(rng), "opt": {"mu": _rand_tree(rng),
                                               "nu": _rand_tree(rng),
                                               "count": np.int32(7)},
            "model_state": {}}


def _same_state(got, want):
    for (p, a), (_, b) in zip(module.leaves(got), module.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """Five saves keeping the last two; a step directory without its DONE
    marker (a crash mid-write) is ignored; the latest restores into the
    template's dtypes."""
    state = train_state_from_numpy(_ckpt_tree(), "cpu")
    d = str(tmp_path / "port")
    for s in range(1, 6):
        ckpt.save(d, s, state, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000005"]
    os.makedirs(os.path.join(d, "step_0000000009"))
    assert ckpt.latest_step(d) == 5
    back, step = ckpt.restore(d, state)
    assert step == 5
    _same_state(back, state)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


def test_checkpoint_written_by_jax_restores(tmp_path):
    tree = _ckpt_tree()
    state = train_state_from_numpy(tree, "cpu")
    jd = str(tmp_path / "jax")
    jckpt.save(jd, 3, jax.tree.map(jnp.asarray, tree))
    back, step = ckpt.restore(jd, state)
    assert step == 3
    _same_state(back, state)


def test_checkpoint_written_by_port_restores_in_jax(tmp_path):
    tree = _ckpt_tree()
    d = str(tmp_path / "port")
    ckpt.save(d, 2, train_state_from_numpy(tree, "cpu"))
    jback, step = jckpt.restore(d, jax.tree.map(jnp.asarray, tree))
    assert step == 2
    for (p, a), (_, b) in zip(module.leaves(jax.device_get(jback)),
                              module.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


# ---------------------------------------------------------------- launch
def test_launch_train_runs_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    assert train_main(["--reduced", "--steps", "2", "--device", "cpu",
                       "--ckpt-dir", d, "--log-every", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-0.6b params=")
    assert out[1].startswith("step     1 loss ") and out[-1] == "done."
    assert ckpt.latest_step(d) == 2
    assert train_main(["--reduced", "--steps", "3", "--device", "cpu",
                       "--ckpt-dir", d, "--microbatch", "2",
                       "--straggler-prob", "0.5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "resumed from step 2" in out and out[-1] == "done."


@pytest.mark.parametrize("arch,extra", [
    ("olmoe-1b-7b", ["--compress-grads"]),
    ("whisper-base", []),
    ("qwen2-vl-7b", ["--microbatch", "2"])])
def test_launch_train_other_families(arch, extra, capsys):
    """The MoE LM (its load EMAs the model state), the encoder-decoder
    (random frame features) and the VLM (random vis_embed) train on the
    CPU through the launcher."""
    assert train_main(["--reduced", "--arch", arch, "--steps", "1",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("step     1 loss ") and out[-1] == "done."
    assert np.isfinite(float(out[1].split()[3]))


# ------------------------------------------------------------- the golden
def test_golden_is_well_formed_and_matches_chip_smoke():
    with open(GOLDEN) as f:
        g = json.load(f)
    smoke = _chip_smoke()
    assert g["arch"] == smoke.TRAIN_ARCH == TRAIN_ARCH
    assert g["seed"] == smoke.TRAIN_SEED == TRAIN_SEED
    assert g["layers"] == smoke.TRAIN_F32_LAYERS == TRAIN_F32_LAYERS
    assert (g["batch"], g["seq"]) == (smoke.TRAIN_F32_BATCH,
                                      smoke.TRAIN_F32_SEQ)
    assert g["steps"] == smoke.TRAIN_F32_STEPS == TRAIN_F32_STEPS
    assert g["opt"] == smoke.TRAIN_OPT == TRAIN_OPT
    assert g["dtype"] == "float32" and g["jax"] and g["seconds"] > 0
    cfg = configs.get_config(TRAIN_ARCH)
    assert g["config"] == {k: getattr(cfg, k) for k in g["config"]}
    assert g["config"]["d_model"] == 1024 and g["config"]["vocab"] == 151936
    for rec in (g, g["witness"]):
        for k in ("loss", "grad_norm", "lr"):
            assert len(rec[k]) == TRAIN_F32_STEPS
            assert all(np.isfinite(rec[k]))
    assert g["loss"][0] > 10.0        # ~ln(vocab) from random weights


# -------------------------------------------- chip_smoke.py's train rules
def test_chip_smoke_per_layer_fan_in_unsaturates_whisper():
    """`chip_smoke.per_layer_fan_in` rescales reduced whisper-base's
    layer-stacked `fan_in` leaves (both packages: std 1/√layers) to
    1/√n, n one layer's inputs (d_model; H·hd for wo, d_ff for wd), and
    leaves every other leaf as drawn; `score_max` then reads the plain
    forward's largest |q·k|/√hd far below the parity draws' (the
    softmax no longer saturates)."""
    smoke = _chip_smoke()
    cfg = configs.get_reduced("whisper-base", n_layers=2, n_enc_layers=2)
    specs = build_model(cfg, device="meta").param_specs()
    batch = {k: torch.as_tensor(v) for k, v in next(data.packed_batches(
        data.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                        seed=0, mean_doc_len=8))).items()}
    batch["enc_feats"] = torch.as_tensor(0.02 * np.random.RandomState(
        0).standard_normal((2, cfg.n_enc_frames, cfg.d_model)),
        dtype=torch.float32)
    scores = []
    for rescale in (False, True):
        params = module.draw(specs, torch.Generator().manual_seed(0),
                             "cpu", lambda path, spec: torch.float32)
        before = {path: t.clone() for path, t in module.leaves(params)}
        st = init_train_state(params, {}, TrainConfig())
        if rescale:
            smoke.per_layer_fan_in(torch, specs, st, cfg.d_model)
        for path, spec in module.leaves(specs):
            got, ratio = st["params"], 1.0
            for k in path:
                got = got[k]
            if rescale and spec.init == "fan_in" \
                    and path[0].endswith("blocks"):
                n = (cfg.d_ff if path[-1] == "wd" else cfg.d_model)
                ratio = (spec.shape[0] / n) ** 0.5
            torch.testing.assert_close(got, before[path] * ratio)
        with smoke.score_max(torch) as seen:
            loss_and_grads(build_model(cfg, device="meta", impl="ref"),
                           st["params"], {}, batch)
        assert len(seen) == 6          # 2 encoder, 2 self, 2 cross
        scores.append(max(seen))
    assert scores[0] > 100.0 and scores[1] < 10.0, scores


def test_chip_smoke_train_gap_rule_holds_each_gap():
    """`train_gap_rule` holds the loss and the gradient norm, step 1 and
    the later steps, each against its own largest witness gap (exact
    arithmetic on hand-made runs: no tolerance), and only the gaps that
    `hold` names."""
    smoke = _chip_smoke()

    def run(*pairs):
        return [{"loss": lo, "grad_norm": gn} for lo, gn in pairs]
    plain = run((10.0, 5.0), (9.0, 4.0), (8.0, 3.0))
    wits = [run((10.5, 5.25), (9.25, 4.0), (8.0, 3.5)),
            run((10.0, 5.0), (9.0, 4.5), (8.0, 3.0))]
    got, lim, bad = smoke.train_gap_rule(
        run((10.75, 5.25), (9.25, 4.75), (8.0, 3.0)), plain, wits)
    assert got == {"loss": [0.75, 0.25], "grad_norm": [0.25, 0.75]}
    assert lim == {"loss": [0.5, 0.25], "grad_norm": [0.25, 0.5]}
    assert bad == []
    _, _, bad = smoke.train_gap_rule(
        run((11.0, 5.5), (9.0, 4.0), (8.0, 3.0)), plain, wits)
    assert [b.split()[:3] for b in bad] == [["loss", "step", "1"],
                                            ["grad_norm", "step", "1"]]
    _, _, bad = smoke.train_gap_rule(
        run((11.0, 5.5), (9.0, 4.0), (8.0, 3.0)), plain, wits,
        hold=(("loss", 1), ("grad_norm", 1)))
    assert bad == []


def test_chip_smoke_leaf_gap_rule_finds_a_zeroed_leaf():
    """`leaf_gap_rule`: a gradient within 1.5x the witnesses' distance in
    every leaf passes; one leaf zeroed (a fault in one layer) fails
    there, although the global norm moves by less than the witnesses'
    spread in it; a leaf no witness moves is held to its floor."""
    smoke = _chip_smoke()
    rng = np.random.RandomState(0)
    plain = {f"w[{i}]": torch.tensor(rng.randn(64), dtype=torch.float32)
             for i in range(4)}
    plain["big"] = torch.tensor(100.0 * rng.randn(64), dtype=torch.float32)

    def moved(scale, seed):
        r = np.random.RandomState(seed)
        return {k: v + scale * float(v.norm()) / 8.0 * torch.tensor(
            r.randn(64), dtype=torch.float32) for k, v in plain.items()}
    wits = [moved(0.1, 1), moved(0.1, 2)]
    summary, bad = smoke.leaf_gap_rule(moved(0.1, 3), plain, wits)
    assert bad == [] and summary["largest"] == "big"
    faulty = dict(moved(0.1, 3), **{"w[2]": torch.zeros(64)})
    _, bad = smoke.leaf_gap_rule(faulty, plain, wits)
    assert len(bad) == 1 and "w[2]" in bad[0]
    norm = smoke.grad_norm
    assert abs(norm(faulty) - norm(plain)) < max(
        abs(norm(w) - norm(plain)) for w in wits) * 1.5 + 1.0
    still = {k: v.clone() for k, v in plain.items()}
    _, bad = smoke.leaf_gap_rule(dict(still, **{"w[0]": plain["w[0]"] * (
        1 + 2.0 ** -7)}), plain, [still])
    assert len(bad) == 1 and "w[0]" in bad[0]


def test_chip_smoke_split_p_is_the_plain_attention():
    """`split_p`, the plain attention with P in bfloat16 parts: three
    parts are float32's precision (within 1e-6 of the plain version,
    segments and GQA), two parts carry P to 2^-17 (2^-14 over these 24
    keys); its gradient is the plain one to the same bounds; the plain
    version given back on exit."""
    from repro_torch.kernels import ops, ref
    smoke = _chip_smoke()
    rng = np.random.RandomState(1)
    q, k, v = (torch.tensor(rng.randn(2, h, 24, 16), dtype=torch.float32,
                            requires_grad=True) for h in (4, 2, 2))
    seg = torch.tensor(np.repeat([[1, 1, 2, 3]], 6, axis=1)[:, :24]
                       .repeat(2, axis=0), dtype=torch.int32)
    plain_fn = ref.flash_attention_ref
    want = ref.flash_attention_ref(q, k, v, True, seg)
    gw = torch.autograd.grad(want.sum(), (q, k, v))
    for parts, tol in ((3, 1e-6), (2, 2.0 ** -14)):
        with smoke.split_p(torch, parts):
            got = ops.flash_attention(q, k, v, True, impl="ref",
                                      segment_ids=seg)
        assert ref.flash_attention_ref is plain_fn
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=0, atol=tol)
        for a, b in zip(torch.autograd.grad(got.sum(), (q, k, v)), gw):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=tol)


def write_golden():
    t0 = time.time()
    cfg = jconfigs.get_config(TRAIN_ARCH).replace(
        n_layers=TRAIN_F32_LAYERS, compute_dtype=jnp.float32)
    jmodel = jbuild(cfg)
    pcfg = configs.get_config(TRAIN_ARCH).replace(
        n_layers=TRAIN_F32_LAYERS, compute_dtype=torch.float32)
    params = module.init(build_model(pcfg, device="meta").param_specs(),
                         TRAIN_SEED)
    tc = jtrain.TrainConfig(opt=joptim.OptConfig(**TRAIN_OPT))
    step = jax.jit(jtrain.build_train_step(jmodel, tc))
    batches = jdata.packed_batches(jdata.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_F32_SEQ,
        global_batch=TRAIN_F32_BATCH, seed=TRAIN_SEED))
    batches = [next(batches) for _ in range(TRAIN_F32_STEPS)]

    def run(p):
        st = jtrain.init_train_state(jax.tree.map(jnp.asarray, p), {}, tc)
        rec = {"loss": [], "grad_norm": [], "lr": []}
        for b in batches:
            st, m = step(st, b)
            for k in rec:
                rec[k].append(float(m[k]))
            print(TRAIN_ARCH, {k: v[-1] for k, v in rec.items()},
                  flush=True)
        return rec

    rec = run(params)
    witness = run(one_ulp_up(params))
    pc = configs.get_config(TRAIN_ARCH)
    golden = {"arch": TRAIN_ARCH, "seed": TRAIN_SEED,
              "layers": TRAIN_F32_LAYERS, "batch": TRAIN_F32_BATCH,
              "seq": TRAIN_F32_SEQ, "steps": TRAIN_F32_STEPS,
              "opt": TRAIN_OPT, "dtype": "float32", "jax": jax.__version__,
              "config": {k: getattr(pc, k) for k in (
                  "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "qk_norm", "tie_embeddings",
                  "rope_theta", "norm_eps")},
              **rec, "witness": witness, "seconds": time.time() - t0}
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
    print(f"wrote {GOLDEN} in {golden['seconds']:.0f} s")


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
