"""Serving driver of the port: the SGP request router plans the
pod-level dispatch, then batched decode of random prompts runs through
`ServingEngine` on a model built from the registry.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --requests 12 --max-new 16 --device cpu

`--arch` takes every family of the registry: the dense attention LMs
(qwen3-0.6b and the like), the MoE LMs (olmoe-1b-7b: its router's load
EMAs are the model state the engine threads through every call),
mamba2-130m, the hybrid, the VLM (qwen2-vl-7b: M-RoPE, text-only
prompts) and the encoder-decoder (whisper-base: the engine feeds the
stub frontend's zero frame features); `--full` serves at the config's
full width.
Mamba2 prompts must be at most `ssm_chunk` tokens long or a multiple of
it (the JAX model path's contract); the drawn prompts (4 to 11 tokens)
are.

As in the JAX package's `repro.launch.serve`, the router plans first:
two pods of 40 and 25 tokens/s (speeds 1.0 and 0.8), one frontend, one
class at `requests / 10` tokens/s, and prints the plan's cost and pod
utilizations.  Weights are random, drawn from `--seed`: with
numpy at the reduced size (`models.module.init`, the stream the tests
share with the JAX package), with a `torch.Generator` on the model's
device at full width (`models.module.draw`; OLMoE's 6.9 B values would
take minutes in numpy, qwen2-vl-7b's 7.6 B longer).  Without `--device`
the model runs on the card; the CPU only when asked for.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import (lm_leaf_dtypes, lm_params_from_numpy,
                                 lm_params_from_tensors)
from repro_torch.models import build_model, module
from repro_torch.serving import (PodSpec, Request, RequestRouter,
                                 ServeConfig, ServingEngine)


def make_requests(n: int, vocab: int, seed: int, lo: int = 4,
                  hi: int = 12) -> list:
    """n requests with prompt lengths drawn from [lo, hi) and tokens
    from [2, vocab), both from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(2, vocab,
                                              size=rng.randint(lo, hi))
                    .astype(np.int32))
            for i in range(n)]


def load_model(cfg, seed: int, device=None, impl=None,
               draw: str = "numpy"):
    """The port's model (`build_model`: an `LM`, or an `EncDecLM` for
    the encoder-decoder family) on `device` with weights drawn from
    `seed`: with
    numpy (`draw="numpy"`, `models.module.init`) or with a
    `torch.Generator` on the model's device, each leaf in the dtype the
    model keeps it in (`draw="torch"`, `models.module.draw`)."""
    model = build_model(cfg, device=device, impl=impl)
    if draw == "numpy":
        tree = module.init(model.param_specs(), seed)
        sd = lm_params_from_numpy(cfg, tree, model.device)
    elif draw == "torch":
        gen = torch.Generator(device=model.device).manual_seed(seed)
        tree = module.draw(model.param_specs(), gen, model.device,
                           lm_leaf_dtypes(model))
        sd = lm_params_from_tensors(cfg, tree)
    else:
        raise ValueError(f"unknown draw {draw!r}")
    model.load_state_dict(sd)
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=list(configs.ARCH_IDS))
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="reduced", action="store_true",
                      default=True)
    size.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # the pod-level dispatch plan (the paper's optimizer as the scheduler)
    pods = [PodSpec(capacity=40.0, speed=1.0),
            PodSpec(capacity=25.0, speed=0.8)]
    router = RequestRouter(pods, n_frontends=1, classes={"gen": 1.0},
                           demand=np.array([[args.requests / 10.0]]),
                           device=args.device)
    plan = router.plan()
    print(f"router: cost={plan['total_cost']:.3f} "
          f"pod_util={np.round(plan['pod_utilization'], 3)}", flush=True)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    model = load_model(cfg, args.seed, args.device,
                       draw="numpy" if args.reduced else "torch")
    engine = ServingEngine(model, ServeConfig(max_slots=args.slots,
                                              max_len=args.max_len,
                                              max_new_tokens=args.max_new))
    reqs = make_requests(args.requests, cfg.vocab, args.seed)
    t0 = time.perf_counter()
    engine.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s on {model.device})",
          flush=True)
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
