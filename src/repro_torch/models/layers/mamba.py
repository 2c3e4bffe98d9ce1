"""Mamba2 block (PyTorch port of the JAX package's
`models/layers/mamba.py`): split projections -> causal depthwise conv ->
SSD -> gated norm -> out-proj, one B/C group.

The prefill's SSD goes through `kernels.ops.ssd_scan` (K6): the Hopper
kernel on the card, `ssd_chunked` on the CPU (`impl="ref"` forces the
plain version).  The decode step is plain PyTorch (`ssd_decode_step`),
as in the JAX package, which has no kernel for it.

Parameters `p` are the port's, by the JAX package's names and layouts:
in_z / in_x [d, d_inner], in_B / in_C [d, N], in_dt [d, H], conv_x /
conv_B / conv_C [4, width] and their biases conv_bx / conv_bB / conv_bC,
out_proj [d_inner, d] in the compute dtype (the JAX package casts them at
each use, which gives the same numbers); A_log, D, dt_bias [H] and the
norm scale float32.  `D` is cast to the compute dtype at use, as there.

Decode caches per layer: the SSM state [B, H, N, P] (float32) and the
tails of the x / B / C projections [B, 3, width] (the cache dtype).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kernels import ops
from ..module import ParamSpec
from .norms import rmsnorm, rmsnorm_spec
from .ssd import ssd_decode_step

CONV_K = 4


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def mamba_specs(cfg) -> dict:
    """The JAX package's parameter specs (JAX layout)."""
    d = cfg.d_model
    di = d_inner(cfg)
    N = cfg.ssm_state
    H = n_ssm_heads(cfg)
    dt = cfg.param_dtype
    return {
        "in_z": ParamSpec((d, di), ("embed", "mlp"), dt),
        "in_x": ParamSpec((d, di), ("embed", "mlp"), dt),
        "in_B": ParamSpec((d, N), ("embed", None), dt),
        "in_C": ParamSpec((d, N), ("embed", None), dt),
        "in_dt": ParamSpec((d, H), ("embed", "heads"), dt),
        "conv_x": ParamSpec((CONV_K, di), (None, "mlp"), dt,
                            init="normal", scale=0.1),
        "conv_B": ParamSpec((CONV_K, N), (None, None), dt,
                            init="normal", scale=0.1),
        "conv_C": ParamSpec((CONV_K, N), (None, None), dt,
                            init="normal", scale=0.1),
        "conv_bx": ParamSpec((di,), ("mlp",), dt, init="zeros"),
        "conv_bB": ParamSpec((N,), (None,), dt, init="zeros"),
        "conv_bC": ParamSpec((N,), (None,), dt, init="zeros"),
        "A_log": ParamSpec((H,), ("heads",), torch.float32, init="zeros"),
        "D": ParamSpec((H,), ("heads",), torch.float32, init="ones"),
        "dt_bias": ParamSpec((H,), ("heads",), torch.float32, init="zeros"),
        "norm": rmsnorm_spec(di, "mlp"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed"), dt),
    }


# the port's parameter of each name: matrices and conv weights in the
# compute dtype, the rest float32
COMPUTE_DTYPE_LEAVES = ("in_z", "in_x", "in_B", "in_C", "in_dt", "conv_x",
                        "conv_B", "conv_C", "conv_bx", "conv_bB", "conv_bC",
                        "out_proj")


def _causal_conv(x, w, b):
    """Depthwise causal conv, kernel CONV_K, as four shifted products and
    the bias (no cuDNN: its float32 convolutions run in TF32 by
    default).  x [B, L, C]."""
    L = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, CONV_K - 1, 0))
    out = sum(pad[:, k:k + L] * w[k][None, None] for k in range(CONV_K))
    return out + b[None, None]


def _project(p, x):
    return x @ p["in_z"], x @ p["in_x"], x @ p["in_B"], x @ p["in_C"], \
        x @ p["in_dt"]


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gate_out(p, y, z, cfg):
    y = rmsnorm(p["norm"], y * torch.nn.functional.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]


def mamba(p, x, cfg, init_state: Optional[torch.Tensor] = None,
          impl: Optional[str] = None):
    """The prefill.  x [B, L, D] -> (y [B, L, D], cache pieces {"ssm":
    final state [B, H, N, P] float32, "conv_x" / "conv_B" / "conv_C": the
    last CONV_K - 1 rows of the x / B / C projections, zero-padded on the
    left when L < CONV_K - 1, in the cache dtype}).  L must be a
    multiple of min(cfg.ssm_chunk, L), as the JAX package asserts."""
    B, L, _ = x.shape
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim
    di = d_inner(cfg)
    silu = torch.nn.functional.silu

    z, xr, Br, Cr, dtv = _project(p, x)
    xc = silu(_causal_conv(xr, p["conv_x"], p["conv_bx"]))
    Bc = silu(_causal_conv(Br, p["conv_B"], p["conv_bB"]))
    Cc = silu(_causal_conv(Cr, p["conv_C"], p["conv_bC"]))
    xs = xc.reshape(B, L, H, P)

    dt = _softplus(dtv.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    y, state = ops.ssd_scan(xs, dt, A, Bc, Cc, init_state=init_state,
                            chunk=min(cfg.ssm_chunk, L), impl=impl)
    y = y + p["D"][None, None, :, None].to(cfg.compute_dtype) * xs
    out = _gate_out(p, y.reshape(B, L, di), z, cfg)

    def tail(t):
        t = t[:, -(CONV_K - 1):]
        pad = CONV_K - 1 - t.shape[1]
        return torch.nn.functional.pad(t, (0, 0, pad, 0)).to(cfg.cache_dtype)

    return out, {"ssm": state, "conv_x": tail(xr), "conv_B": tail(Br),
                 "conv_C": tail(Cr)}


def mamba_cache_shapes(cfg, batch: int) -> dict:
    H, P, N = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    return {"ssm": (batch, H, N, P),
            "conv_x": (batch, CONV_K - 1, d_inner(cfg)),
            "conv_B": (batch, CONV_K - 1, N),
            "conv_C": (batch, CONV_K - 1, N)}


def _conv_step(window, new, w, b):
    """window [B, K-1, C] + new [B, 1, C] -> (out [B, 1, C], the new
    window [B, K-1, C] in new's dtype)."""
    full = torch.cat([window.to(new.dtype), new], dim=1)
    out = sum(full[:, k:k + 1] * w[k][None, None]
              for k in range(CONV_K)) + b[None, None]
    return out, full[:, 1:]


def mamba_decode(p, cache, x, cfg):
    """One-token decode.  x [B, 1, D], cache {"ssm", "conv_x", "conv_B",
    "conv_C"} of this layer -> (y [B, 1, D], the new cache pieces: state
    float32, windows cast to the cache's dtypes)."""
    B = x.shape[0]
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim
    di = d_inner(cfg)
    silu = torch.nn.functional.silu

    z, xr, Br, Cr, dtv = _project(p, x)
    xc, wx = _conv_step(cache["conv_x"], xr, p["conv_x"], p["conv_bx"])
    Bc, wB = _conv_step(cache["conv_B"], Br, p["conv_B"], p["conv_bB"])
    Cc, wC = _conv_step(cache["conv_C"], Cr, p["conv_C"], p["conv_bC"])
    xs = silu(xc)[:, 0].reshape(B, H, P)
    Bc = silu(Bc)[:, 0]
    Cc = silu(Cc)[:, 0]

    dt = _softplus(dtv[:, 0].float() + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])
    y, state = ssd_decode_step(cache["ssm"], xs, dt, A, Bc, Cc)
    y = y + p["D"][None, :, None].to(cfg.compute_dtype) * xs
    out = _gate_out(p, y.reshape(B, 1, di), z, cfg)
    return out, {"ssm": state,
                 "conv_x": wx.to(cache["conv_x"].dtype),
                 "conv_B": wB.to(cache["conv_B"].dtype),
                 "conv_C": wC.to(cache["conv_C"].dtype)}
