"""Decoder language model: the dense attention, MoE, Mamba2 (SSM) and
hybrid families (PyTorch port of the JAX package's `models/lm.py`).

    LM(cfg).param_specs()                          -> spec tree (JAX layout)
    LM(cfg).state_specs()                          -> model-state spec tree
    LM(cfg).init_cache_specs(batch, max_len)       -> cache spec tree
    LM(cfg).prefill(state, cache, tokens)          -> (logits, state, cache)
    LM(cfg).decode_step(state, cache, tokens, pos) -> (logits, state, cache)

Weights live in the module (load them with `convert.lm_params_from_numpy`
and `load_state_dict`): the matrices (the Mamba conv weights and biases
and the MoE experts too) in the compute dtype (cast once at load, which
gives the numbers of the JAX package's cast at each use), the norm
scales and Mamba's A_log, D and dt_bias in the parameter dtype, the MoE
router in float32.  Layers are a plain `nn.ModuleList`, no layer
stacking.  The cache keeps the JAX layout, n_layers / period groups
stacked first: an attention slot holds {"k", "v": [G, B, S_max, KV,
hd]}, a Mamba slot {"ssm": [G, B, H, N, P] float32, "conv_x" / "conv_B"
/ "conv_C": [G, B, 3, width] in the cache dtype}; prefill and decode
write it in place, and a prefill overwrites every leaf of the lanes it
is given.

The model state is the JAX package's: the MoE router's load EMAs, one
{"load_ema": [G, E] float32} per MoE slot (`state_specs()`, no batch
axis: engine-global).  prefill and decode_step take it and return the
new state as new tensors; a model without MoE layers has the empty
state {}.  After each call `metrics` holds the MoE layers'
moe_imbalance and moe_drop_frac (means over the layers) and router_gap
(their minimum), as 0-dim tensors.  M-RoPE and the encoder-decoder
family raise NotImplementedError (ROADMAP queue 1).

`impl` steers every kernel of the model (K4 and K5 in attention, K6 in
the Mamba prefill, K7 in the MoE FFN): None takes the Hopper kernels on
the card and the plain versions on the CPU; "ref" forces the plain
versions.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import ModelConfig
from .module import ParamSpec
from .layers import attention as attn
from .layers import mamba as mb
from .layers import mlp as mlpl
from .layers import moe as moel
from .layers.norms import rmsnorm, rmsnorm_spec
from .layers.rope import rope_angles


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
    if cfg.mrope_sections:
        raise NotImplementedError(f"{cfg.name}: M-RoPE comes with the VLM "
                                  "slice (ROADMAP queue 1, P13d)")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 impl: Optional[str] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.period = cfg.scan_period()
        self.n_groups = cfg.n_layers // self.period
        self.pattern = cfg.layer_pattern()[: self.period]
        # None: the Hopper kernels on the card, the plain versions on the
        # CPU; "ref" forces the plain versions
        self.impl = impl
        dev = torch.device("cuda" if device is None else device)
        cd, pd = cfg.compute_dtype, cfg.param_dtype
        d, hd = cfg.d_model, cfg.hd
        self.embed = _param((cfg.vocab, d), cd, dev)
        self.final_norm = _param((d,), pd, dev)
        if not cfg.tie_embeddings:
            self.unembed = _param((d, cfg.vocab), cd, dev)
        layers = []
        for mixer, ffn in cfg.layer_pattern():
            p = {"ln1": _param((d,), pd, dev)}
            if mixer == "attn":
                p.update(wq=_param((d, cfg.n_heads * hd), cd, dev),
                         wk=_param((d, cfg.n_kv_heads * hd), cd, dev),
                         wv=_param((d, cfg.n_kv_heads * hd), cd, dev),
                         wo=_param((cfg.n_heads * hd, d), cd, dev))
                if cfg.qk_norm:
                    p["q_norm"] = _param((hd,), pd, dev)
                    p["k_norm"] = _param((hd,), pd, dev)
            else:
                for name, spec in mb.mamba_specs(cfg).items():
                    p[name] = _param(spec.shape, cd if name in
                                     mb.COMPUTE_DTYPE_LEAVES else spec.dtype,
                                     dev)
            if ffn == "dense":
                p["ln2"] = _param((d,), pd, dev)
                p["wg"] = _param((d, cfg.d_ff), cd, dev)
                p["wu"] = _param((d, cfg.d_ff), cd, dev)
                p["wd"] = _param((cfg.d_ff, d), cd, dev)
            elif ffn == "moe":
                E, f = cfg.n_experts, cfg.d_ff_expert
                p["ln2"] = _param((d,), pd, dev)
                p["router"] = _param((d, E), torch.float32, dev)
                p["wg"] = _param((E, d, f), cd, dev)
                p["wu"] = _param((E, d, f), cd, dev)
                p["wd"] = _param((E, f, d), cd, dev)
            layers.append(nn.ParameterDict(p))
        self.layers = nn.ModuleList(layers)
        self.metrics: dict = {}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- specs
    def _slot_specs(self, mixer: str, ffn: str) -> dict:
        cfg = self.cfg
        d = {"ln1": rmsnorm_spec(cfg.d_model),
             "mixer": (attn.attention_specs(cfg) if mixer == "attn"
                       else mb.mamba_specs(cfg))}
        if ffn != "none":
            d["ln2"] = rmsnorm_spec(cfg.d_model)
            d["ffn"] = (moel.moe_specs(cfg) if ffn == "moe"
                        else mlpl.mlp_specs(cfg))
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

    def state_specs(self) -> dict:
        """Mutable model state: the MoE router load EMAs (the paper's
        G_e), one [n_groups, E] leaf per MoE slot."""
        return {f"slot_{j:02d}": _stack(moel.moe_state_specs(self.cfg),
                                        self.n_groups)
                for j, (_, ffn) in enumerate(self.pattern) if ffn == "moe"}

    def init_cache_specs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        G = self.n_groups
        out = {}
        for j, (mixer, _) in enumerate(self.pattern):
            if mixer == "attn":
                kv = ParamSpec((G, batch, max_len, cfg.n_kv_heads, cfg.hd),
                               ("layers", "batch", "cache_seq", "kv_heads",
                                "head_dim"), cfg.cache_dtype, init="zeros")
                out[f"slot_{j:02d}"] = {"k": kv, "v": kv}
            else:
                sh = mb.mamba_cache_shapes(cfg, batch)
                axes = {"ssm": ("heads", None, None),
                        "conv_x": (None, "mlp"), "conv_B": (None, None),
                        "conv_C": (None, None)}
                out[f"slot_{j:02d}"] = {
                    k: ParamSpec((G,) + sh[k], ("layers", "batch") + axes[k],
                                 torch.float32 if k == "ssm"
                                 else cfg.cache_dtype, init="zeros")
                    for k in sh}
        return out

    # ----------------------------------------------------------- forward
    def _logits(self, x):
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return x @ w

    def _blocks(self, x, cos, sin, state, cache, pos=None):
        """All layers; prefill when pos is None, else one decode step.
        Each layer's cache leaves are written in place; returns x and the
        new model state, and sets `metrics`."""
        cfg = self.cfg
        new_ema, mets = {}, []
        for i, p in enumerate(self.layers):
            g, j = divmod(i, self.period)
            key = f"slot_{j:02d}"
            c = {k: v[g] for k, v in cache[key].items()}
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if self.pattern[j][0] == "mamba":
                if pos is None:
                    out, new = mb.mamba(p, h, cfg, impl=self.impl)
                else:
                    out, new = mb.mamba_decode(p, c, h, cfg)
                for k, v in new.items():
                    c[k].copy_(v)
                x = x + out
            else:
                q, k, v = attn.qkv(p, h, cfg, cos, sin)
                if pos is None:
                    L = x.shape[1]
                    c["k"][:, :L] = k.to(c["k"].dtype)
                    c["v"][:, :L] = v.to(c["v"].dtype)
                    o = attn.full_attention(q, k, v, causal=True,
                                            impl=self.impl)
                else:
                    attn.cache_update(c["k"], c["v"], k, v, pos)
                    o = attn.decode_attention(q, c["k"], c["v"], pos + 1,
                                              impl=self.impl)
                x = x + attn.out_proj(p, o)
            if "router" in p:
                h = rmsnorm(p["ln2"], x, cfg.norm_eps)
                st = {"load_ema": state[key]["load_ema"][g]}
                out, st, met = moel.moe(p, st, h, cfg, impl=self.impl)
                new_ema.setdefault(key, []).append(st["load_ema"])
                mets.append(met)
                x = x + out
            elif "wg" in p:
                x = x + mlpl.mlp(p, rmsnorm(p["ln2"], x, cfg.norm_eps))
        self.metrics = {}
        if mets:
            for name in ("moe_imbalance", "moe_drop_frac"):
                self.metrics[name] = torch.stack(
                    [m[name] for m in mets]).mean()
            self.metrics["router_gap"] = torch.stack(
                [m["router_gap"] for m in mets]).min()
        return x, {key: {"load_ema": torch.stack(v)}
                   for key, v in new_ema.items()}

    @torch.no_grad()
    def prefill(self, state, cache, tokens):
        """tokens [B, L] (L <= the cache's max_len) -> (last-position
        logits [B, vocab], new state, cache with positions [0, L)
        written)."""
        cfg = self.cfg
        B, L = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
        cos, sin = rope_angles(cfg.hd, cfg.rope_theta, positions)
        x, state = self._blocks(x, cos, sin, state, cache)
        x = rmsnorm(self.final_norm, x[:, -1:], cfg.norm_eps)
        return self._logits(x)[:, 0], state, cache

    @torch.no_grad()
    def decode_step(self, state, cache, tokens, pos):
        """tokens [B, 1], pos [B] int32 -> (logits [B, vocab], new state,
        cache with position pos[b] of row b written)."""
        cfg = self.cfg
        x = self.embed[tokens]
        cos, sin = rope_angles(cfg.hd, cfg.rope_theta, pos[:, None])
        x, state = self._blocks(x, cos, sin, state, cache, pos)
        x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)[:, 0], state, cache
