"""Decoder language model, dense attention-only family (PyTorch port of
the JAX package's `models/lm.py`).

    LM(cfg).param_specs()                      -> spec tree (JAX layout)
    LM(cfg).init_cache_specs(batch, max_len)   -> cache spec tree
    LM(cfg).prefill(cache, tokens)             -> (logits, cache)
    LM(cfg).decode_step(cache, tokens, pos)    -> (logits, cache)

Weights live in the module (load them with `convert.lm_params_from_numpy`
and `load_state_dict`): the matrices in the compute dtype (cast once at
load, which gives the numbers of the JAX package's cast at each use),
the norm scales in the parameter dtype.  Layers are a plain
`nn.ModuleList`, no layer stacking.  The cache keeps the JAX layout,
{"slot_00": {"k", "v": [n_layers, B, S_max, KV, hd]}}, and prefill and
decode write it in place.  A dense LM has no mutable state, so the JAX
package's `state` argument is dropped.  Mamba mixers, MoE FFNs, M-RoPE
and the encoder-decoder family raise NotImplementedError (ROADMAP
queue 1).
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

_UNPORTED = {
    "mamba": "the Mamba2 mixer comes with the mamba2-130m serving slice "
             "(ROADMAP queue 1, P13b)",
    "moe": "the MoE FFN comes with the OLMoE serving slice "
           "(ROADMAP queue 1, P13c)",
}


def _stack(specs: dict, g: int) -> dict:
    return {k: (_stack(v, g) if isinstance(v, dict) else
                ParamSpec((g,) + v.shape, ("layers",) + v.axes, v.dtype,
                          v.init, v.scale))
            for k, v in specs.items()}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder LM "
                                  "comes later (ROADMAP queue 1, P13d)")
    for mixer, ffn in cfg.layer_pattern():
        for kind in (mixer, ffn):
            if kind in _UNPORTED:
                raise NotImplementedError(f"{cfg.name}: {_UNPORTED[kind]}")
    if cfg.mrope_sections:
        raise NotImplementedError(f"{cfg.name}: M-RoPE comes with the VLM "
                                  "slice (ROADMAP queue 1, P13d)")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 attn_impl: Optional[str] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.period = cfg.scan_period()
        self.n_groups = cfg.n_layers // self.period
        self.pattern = cfg.layer_pattern()[: self.period]
        # None: the Hopper kernels on the card, the plain versions on the
        # CPU; "ref" forces the plain versions
        self.attn_impl = attn_impl
        dev = torch.device("cuda" if device is None else device)
        cd, pd = cfg.compute_dtype, cfg.param_dtype
        d, hd = cfg.d_model, cfg.hd
        self.embed = _param((cfg.vocab, d), cd, dev)
        self.final_norm = _param((d,), pd, dev)
        if not cfg.tie_embeddings:
            self.unembed = _param((d, cfg.vocab), cd, dev)
        layers = []
        for _, ffn in cfg.layer_pattern():
            p = {"ln1": _param((d,), pd, dev),
                 "wq": _param((d, cfg.n_heads * hd), cd, dev),
                 "wk": _param((d, cfg.n_kv_heads * hd), cd, dev),
                 "wv": _param((d, cfg.n_kv_heads * hd), cd, dev),
                 "wo": _param((cfg.n_heads * hd, d), cd, dev)}
            if cfg.qk_norm:
                p["q_norm"] = _param((hd,), pd, dev)
                p["k_norm"] = _param((hd,), pd, dev)
            if ffn == "dense":
                p["ln2"] = _param((d,), pd, dev)
                p["wg"] = _param((d, cfg.d_ff), cd, dev)
                p["wu"] = _param((d, cfg.d_ff), cd, dev)
                p["wd"] = _param((cfg.d_ff, d), cd, dev)
            layers.append(nn.ParameterDict(p))
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- specs
    def _slot_specs(self, mixer: str, ffn: str) -> dict:
        cfg = self.cfg
        d = {"ln1": rmsnorm_spec(cfg.d_model),
             "mixer": attn.attention_specs(cfg)}
        if ffn != "none":
            d["ln2"] = rmsnorm_spec(cfg.d_model)
            d["ffn"] = mlpl.mlp_specs(cfg)
        return d

    def param_specs(self) -> dict:
        """The JAX package's parameter tree (its layout, its init rules)."""
        cfg = self.cfg
        tbl_axes = (("vocab_off", "embed_tbl_d") if cfg.embed_tbl_shard
                    else ("vocab", "embed_tbl"))
        specs = {
            "embed": ParamSpec((cfg.vocab, cfg.d_model), tbl_axes,
                               cfg.param_dtype, init="normal", scale=0.02),
            "final_norm": rmsnorm_spec(cfg.d_model),
            "blocks": {f"slot_{j:02d}": _stack(self._slot_specs(m, f),
                                               self.n_groups)
                       for j, (m, f) in enumerate(self.pattern)},
        }
        if not cfg.tie_embeddings:
            specs["unembed"] = ParamSpec(
                (cfg.d_model, cfg.vocab), ("embed_tbl", "vocab"),
                cfg.param_dtype, init="fan_in")
        return specs

    def init_cache_specs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        kv = ParamSpec((self.n_groups, batch, max_len, cfg.n_kv_heads,
                        cfg.hd),
                       ("layers", "batch", "cache_seq", "kv_heads",
                        "head_dim"), cfg.cache_dtype, init="zeros")
        return {f"slot_{j:02d}": {"k": kv, "v": kv}
                for j in range(self.period)}

    # ----------------------------------------------------------- forward
    def _logits(self, x):
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return x @ w

    def _blocks(self, x, cos, sin, cache, pos=None):
        """All layers; prefill when pos is None, else one decode step."""
        cfg = self.cfg
        for i, p in enumerate(self.layers):
            g, j = divmod(i, self.period)
            kc = cache[f"slot_{j:02d}"]["k"][g]
            vc = cache[f"slot_{j:02d}"]["v"][g]
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = attn.qkv(p, h, cfg, cos, sin)
            if pos is None:
                L = x.shape[1]
                kc[:, :L] = k.to(kc.dtype)
                vc[:, :L] = v.to(vc.dtype)
                o = attn.full_attention(q, k, v, causal=True,
                                        impl=self.attn_impl)
            else:
                attn.cache_update(kc, vc, k, v, pos)
                o = attn.decode_attention(q, kc, vc, pos + 1,
                                          impl=self.attn_impl)
            x = x + attn.out_proj(p, o)
            if "wg" in p:
                x = x + mlpl.mlp(p, rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x

    @torch.no_grad()
    def prefill(self, cache, tokens):
        """tokens [B, L] (L <= the cache's max_len) -> (last-position
        logits [B, vocab], cache with positions [0, L) written)."""
        cfg = self.cfg
        B, L = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
        cos, sin = rope_angles(cfg.hd, cfg.rope_theta, positions)
        x = self._blocks(x, cos, sin, cache)
        x = rmsnorm(self.final_norm, x[:, -1:], cfg.norm_eps)
        return self._logits(x)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """tokens [B, 1], pos [B] int32 -> (logits [B, vocab], cache with
        position pos[b] of row b written)."""
        cfg = self.cfg
        x = self.embed[tokens]
        cos, sin = rope_angles(cfg.hd, cfg.rope_theta, pos[:, None])
        x = self._blocks(x, cos, sin, cache, pos)
        x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)[:, 0], cache
