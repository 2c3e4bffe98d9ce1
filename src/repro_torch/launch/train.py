"""End-to-end training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu

The same flags as the JAX package's `repro.launch.train`, plus
`--device` (default: the card; the CPU only when asked for).  Without
`--reduced` it trains the config at full width.  Features exercised:
packed synthetic data (`data.packed_batches`), microbatch accumulation,
AdamW with the warmup-cosine schedule, optional int8 gradient
compression, atomic checkpoints with resume, straggler drop and
renormalisation.  Weights are random: drawn with numpy from `--seed` at
the reduced size (`models.module.init`, the stream the tests share with
the JAX package), with a `torch.Generator` on the device at full width
(`models.module.draw`).  The stub frontends' inputs (whisper's
`enc_feats`, the VLM's `vis_embed`) are 0.02·N(0, 1) drawn from a
`torch.Generator` seeded by `--seed`.  The model is built on the
"meta" device: the train state holds every weight.  Mamba2 and Jamba
(a Mamba2 mixer) raise NotImplementedError (ROADMAP P13e).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.network import resolve_device
from repro_torch.data import DataConfig, StragglerSimulator, packed_batches
from repro_torch.models import build_model, module
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, build_train_step, init_train_state


def init_params(model, seed: int, reduced: bool, device):
    """The train state's float32 master weights in the JAX layout: numpy
    at the reduced size, a torch.Generator on `device` at full width."""
    specs = model.param_specs()
    if reduced:
        return train_state_from_numpy(module.init(specs, seed), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return module.draw(specs, gen, device,
                       lambda path, spec: torch.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    model = build_model(cfg, device="meta")
    tc = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      decay_steps=args.steps),
        n_microbatch=args.microbatch,
        grad_compression=args.compress_grads)

    params = init_params(model, args.seed, args.reduced, dev)
    mstate = module.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        model.state_specs())
    state = init_train_state(params, mstate, tc)
    n_params = module.param_count(model.param_specs())
    print(f"arch={cfg.name} params={n_params:,} "
          f"(reduced={args.reduced})", flush=True)

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start_step = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from step {start_step}", flush=True)

    step_fn = build_train_step(model, tc)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed)
    data = packed_batches(dc)
    straggler = StragglerSimulator(args.straggler_prob, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(data).items()}
        if cfg.family == "encdec":
            batch["enc_feats"] = 0.02 * torch.randn(
                (args.batch, cfg.n_enc_frames, cfg.d_model), generator=gen,
                device=dev)
        if cfg.family == "vlm":
            batch["vis_embed"] = 0.02 * torch.randn(
                (args.batch, args.seq, cfg.d_model), generator=gen,
                device=dev)
        mb_mask = None
        if args.straggler_prob > 0 and tc.n_microbatch > 1:
            mb_mask = torch.tensor(
                [0.0 if straggler.is_late() else 1.0
                 for _ in range(tc.n_microbatch)], device=dev)
        state, metrics = step_fn(state, batch, mb_mask)
        if (step + 1) % args.log_every == 0 or step == start_step:
            dt = time.time() - t0
            tok_s = args.batch * args.seq * args.log_every / max(dt, 1e-9)
            print(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} tok/s {tok_s:,.0f}",
                  flush=True)
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, state)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state)
    print("done.", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
