"""Encoder-decoder transformer, the Whisper-style backbone (PyTorch port
of the JAX package's `models/encdec.py`).

    EncDecLM(cfg).param_specs()                          -> spec tree
    EncDecLM(cfg).state_specs()                          -> {}
    EncDecLM(cfg).init_cache_specs(batch, max_len)       -> cache specs
    EncDecLM(cfg).encode(enc_feats)                      -> encoder output
    EncDecLM(cfg).prefill(state, cache, tokens, enc_feats)
                                                -> (logits, state, cache)
    EncDecLM(cfg).decode_step(state, cache, tokens, pos)
                                                -> (logits, state, cache)

The audio frontend is a stub, as in the JAX package: `enc_feats` are
precomputed frame embeddings [B, F, d_model].  Positions are RoPE, in
the encoder at frame positions 0..F-1 and in the decoder at token
positions; the cross attention rotates neither its queries nor its
keys.  The encoder's self attention is K4 non-causal, the decoder's K4
causal and its cross attention K4 non-causal with L queries against F
keys; a decode step runs K5 twice a layer, on the self cache at
lengths pos + 1 and on the cross cache at length F.

Weights live in the module, with `lm.py`'s rules: the attention and
MLP matrices, `embed` and `unembed` in the compute dtype, the norm
scales in the parameter dtype (load them with
`convert.lm_params_from_numpy`).  Layers mirror the JAX tree, one
module a layer: `enc_blocks.{i}` holds `ln1`, `mixer` (wq [d, H·hd],
wk / wv [d, KV·hd], wo [H·hd, d], q_norm / k_norm under qk-norm),
`ln2` and `ffn` (wg, wu, wd); `dec_blocks.{i}` holds `ln1`,
`self_attn`, `lnx`, `cross_attn`, `ln2` and `ffn`.  The cache keeps
the JAX layout, decoder layers first: `self_k` / `self_v` [n_dec, B,
max_len, KV, hd] and `cross_k` / `cross_v` [n_dec, B, F, KV, hd];
prefill writes the self caches' first L positions and the whole cross
caches of the lanes it is given, decode the self caches at pos.
There is no model state ({}).  The training loss is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import ModelConfig
from .module import ParamSpec
from .layers import attention as attn
from .layers import mlp as mlpl
from .layers.norms import rmsnorm, rmsnorm_spec
from .layers.rope import rope_angles


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _stack(specs: dict, g: int) -> dict:
    return {k: (_stack(v, g) if isinstance(v, dict) else
                ParamSpec((g,) + v.shape, ("layers",) + v.axes, v.dtype,
                          v.init, v.scale))
            for k, v in specs.items()}


class _Block(nn.Module):
    """One layer's parameters by name: norm scales as parameters, the
    attention and FFN weights as `ParameterDict`s; `block[name]` reads
    them."""

    def __init__(self, parts: dict):
        super().__init__()
        for name, v in parts.items():
            setattr(self, name, v)

    def __getitem__(self, name):
        return getattr(self, name)


class EncDecLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 impl: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.n_enc = cfg.n_enc_layers or cfg.n_layers
        self.n_dec = cfg.n_layers
        # None: the Hopper kernels on the card, the plain versions on the
        # CPU; "ref" forces the plain versions
        self.impl = impl
        dev = torch.device("cuda" if device is None else device)
        cd, pd = cfg.compute_dtype, cfg.param_dtype
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

        def attention():
            p = {"wq": _param((d, H * hd), cd, dev),
                 "wk": _param((d, KV * hd), cd, dev),
                 "wv": _param((d, KV * hd), cd, dev),
                 "wo": _param((H * hd, d), cd, dev)}
            if cfg.qk_norm:
                p["q_norm"] = _param((hd,), pd, dev)
                p["k_norm"] = _param((hd,), pd, dev)
            return nn.ParameterDict(p)

        def ffn():
            return nn.ParameterDict({"wg": _param((d, cfg.d_ff), cd, dev),
                                     "wu": _param((d, cfg.d_ff), cd, dev),
                                     "wd": _param((cfg.d_ff, d), cd, dev)})

        def norm():
            return _param((d,), pd, dev)

        self.embed = _param((cfg.vocab, d), cd, dev)
        self.enc_blocks = nn.ModuleList(
            _Block({"ln1": norm(), "mixer": attention(), "ln2": norm(),
                    "ffn": ffn()}) for _ in range(self.n_enc))
        self.enc_norm = norm()
        self.dec_blocks = nn.ModuleList(
            _Block({"ln1": norm(), "self_attn": attention(), "lnx": norm(),
                    "cross_attn": attention(), "ln2": norm(), "ffn": ffn()})
            for _ in range(self.n_dec))
        self.final_norm = norm()
        self.unembed = _param((d, cfg.vocab), cd, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- specs
    def param_specs(self) -> dict:
        """The JAX package's parameter tree (its layout, its init rules)."""
        cfg = self.cfg
        d = cfg.d_model
        enc = {"ln1": rmsnorm_spec(d), "mixer": attn.attention_specs(cfg),
               "ln2": rmsnorm_spec(d), "ffn": mlpl.mlp_specs(cfg)}
        dec = {"ln1": rmsnorm_spec(d),
               "self_attn": attn.attention_specs(cfg),
               "lnx": rmsnorm_spec(d),
               "cross_attn": attn.attention_specs(cfg),
               "ln2": rmsnorm_spec(d), "ffn": mlpl.mlp_specs(cfg)}
        return {
            "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"),
                               cfg.param_dtype, init="normal", scale=0.02),
            "enc_blocks": _stack(enc, self.n_enc),
            "enc_norm": rmsnorm_spec(d),
            "dec_blocks": _stack(dec, self.n_dec),
            "final_norm": rmsnorm_spec(d),
            "unembed": ParamSpec((d, cfg.vocab), ("embed", "vocab"),
                                 cfg.param_dtype, init="fan_in"),
        }

    def state_specs(self) -> dict:
        return {}

    def init_cache_specs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        kv = ParamSpec((self.n_dec, batch, max_len, cfg.n_kv_heads, cfg.hd),
                       ("layers", "batch", "cache_seq", "kv_heads",
                        "head_dim"), cfg.cache_dtype, init="zeros")
        cross = ParamSpec((self.n_dec, batch, cfg.n_enc_frames,
                           cfg.n_kv_heads, cfg.hd),
                          ("layers", "batch", None, "kv_heads", "head_dim"),
                          cfg.cache_dtype, init="zeros")
        return {"self_k": kv, "self_v": kv, "cross_k": cross,
                "cross_v": cross}

    # ----------------------------------------------------------- forward
    @torch.no_grad()
    def encode(self, enc_feats: torch.Tensor) -> torch.Tensor:
        """enc_feats [B, F, D] (the stub frontend's output) -> [B, F, D]
        in the compute dtype."""
        cfg = self.cfg
        x = enc_feats.to(self.device, cfg.compute_dtype)
        B, F, _ = x.shape
        pos = torch.arange(F, device=x.device)[None].expand(B, F)
        cos, sin = rope_angles(cfg.hd, cfg.rope_theta, pos)
        for p in self.enc_blocks:
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = attn.qkv(p["mixer"], h, cfg, cos, sin)
            o = attn.full_attention(q, k, v, causal=False, impl=self.impl)
            x = x + attn.out_proj(p["mixer"], o)
            x = x + mlpl.mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
        return rmsnorm(self.enc_norm, x, cfg.norm_eps)

    def _logits(self, x):
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return (x @ self.unembed)[:, 0]

    @torch.no_grad()
    def prefill(self, state, cache, tokens, enc_feats):
        """tokens [B, L] (L <= the cache's max_len), enc_feats [B, F, D]
        (F the cache's frame count) -> (last-position logits [B, vocab],
        state, cache with the self caches' positions [0, L) and the
        whole cross caches written)."""
        cfg = self.cfg
        enc_out = self.encode(enc_feats)
        B, L = tokens.shape
        x = self.embed[tokens]
        pos = torch.arange(L, device=tokens.device)[None].expand(B, L)
        cos, sin = rope_angles(cfg.hd, cfg.rope_theta, pos)
        for i, p in enumerate(self.dec_blocks):
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = attn.qkv(p["self_attn"], h, cfg, cos, sin)
            cache["self_k"][i, :, :L] = k.to(cache["self_k"].dtype)
            cache["self_v"][i, :, :L] = v.to(cache["self_v"].dtype)
            o = attn.full_attention(q, k, v, causal=True, impl=self.impl)
            x = x + attn.out_proj(p["self_attn"], o)

            h = rmsnorm(p["lnx"], x, cfg.norm_eps)
            q = attn.cross_q(p["cross_attn"], h, cfg)
            kx, vx = attn.cross_kv(p["cross_attn"], enc_out, cfg)
            cache["cross_k"][i] = kx.to(cache["cross_k"].dtype)
            cache["cross_v"][i] = vx.to(cache["cross_v"].dtype)
            o = attn.full_attention(q, kx, vx, causal=False, impl=self.impl)
            x = x + attn.out_proj(p["cross_attn"], o)

            x = x + mlpl.mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
        return self._logits(x[:, -1:]), state, cache

    @torch.no_grad()
    def decode_step(self, state, cache, tokens, pos):
        """tokens [B, 1], pos [B] int32 -> (logits [B, vocab], state,
        cache with position pos[b] of row b's self caches written); the
        cross attention reads all F frames of every row."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        B = tokens.shape[0]
        x = self.embed[tokens]
        cos, sin = rope_angles(cfg.hd, cfg.rope_theta, pos[:, None])
        F = cache["cross_k"].shape[2]
        frames = torch.full((B,), F, dtype=torch.int32, device=x.device)
        for i, p in enumerate(self.dec_blocks):
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = attn.qkv(p["self_attn"], h, cfg, cos, sin)
            kc, vc = attn.cache_update(cache["self_k"][i],
                                       cache["self_v"][i], k, v, pos)
            o = attn.decode_attention(q, kc, vc, pos + 1, impl=self.impl)
            x = x + attn.out_proj(p["self_attn"], o)

            h = rmsnorm(p["lnx"], x, cfg.norm_eps)
            q = attn.cross_q(p["cross_attn"], h, cfg)
            o = attn.decode_attention(q, cache["cross_k"][i].to(cd),
                                      cache["cross_v"][i].to(cd), frames,
                                      impl=self.impl)
            x = x + attn.out_proj(p["cross_attn"], o)

            x = x + mlpl.mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
        return self._logits(x), state, cache
