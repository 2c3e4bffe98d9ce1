"""Decoder language model: the dense attention, MoE, Mamba2 (SSM),
hybrid and VLM families (PyTorch port of the JAX package's
`models/lm.py`; the encoder-decoder family is `models/encdec.py`).

    LM(cfg).param_specs()                          -> spec tree (JAX layout)
    LM(cfg).state_specs()                          -> model-state spec tree
    LM(cfg).init_cache_specs(batch, max_len)       -> cache spec tree
    LM(cfg).prefill(state, cache, tokens)          -> (logits, state, cache)
    LM(cfg).decode_step(state, cache, tokens, pos) -> (logits, state, cache)
    LM(cfg).loss(state, batch, params=None)        -> (loss, state, metrics)

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
(their minimum), as 0-dim tensors.  A config with `mrope_sections`
(the VLM) rotates by M-RoPE; prefill and decode feed the text
positions to all three of its components, as the JAX package does.
The VLM's stub vision frontend (`vis_embed`, per-component positions)
enters only through the training loss.

`loss` is the JAX package's `LM.loss`: the masked next-token cross
entropy of a batch {"tokens", "labels" (< 0 masked), and optionally
"segment_ids" (packed sequences: attention masked to the query's
segment), "positions" ([B, S], or [3, B, S] under M-RoPE) and
"vis_embed" [B, S, d]}, differentiable.  It writes no cache.  With
`cfg.remat == "layer"` each layer runs under
`torch.utils.checkpoint` (non-reentrant), so its forward, K4 and K7
included, runs again in the backward pass.  `params` (the module's
parameter names, e.g. the float32 master weights of a train state cast
to the compute dtype) takes the place of the module's own weights; the
train step passes them.  A config with a Mamba2 mixer raises
NotImplementedError: its backward needs one for K6 (ROADMAP P13e).

`impl` steers every kernel of the model (K4 and K5 in attention, K6 in
the Mamba prefill, K7 in the MoE FFN): None takes the Hopper kernels on
the card and the plain versions on the CPU; "ref" forces the plain
versions.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .module import ParamSpec
from .layers import attention as attn
from .layers import mamba as mb
from .layers import mlp as mlpl
from .layers import moe as moel
from .layers.norms import rmsnorm, rmsnorm_spec
from .layers.rope import mrope_angles, rope_angles


def _stack(specs: dict, g: int) -> dict:
    return {k: (_stack(v, g) if isinstance(v, dict) else
                ParamSpec((g,) + v.shape, ("layers",) + v.axes, v.dtype,
                          v.init, v.scale))
            for k, v in specs.items()}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 impl: Optional[str] = None):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the encoder-decoder family is "
                             "models.encdec.EncDecLM (build_model picks it)")
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
    def _angles(self, positions):
        """positions [B, L] -> (cos, sin); under M-RoPE every component
        takes them (text-only tokens), or positions [3, B, L] give each
        component its own."""
        cfg = self.cfg
        if cfg.mrope_sections:
            if positions.dim() == 2:
                positions = positions[None].expand(3, *positions.shape)
            return mrope_angles(cfg.hd, cfg.rope_theta, positions,
                                cfg.mrope_sections)
        return rope_angles(cfg.hd, cfg.rope_theta, positions)

    def _logits(self, x):
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return x @ w

    def _layer(self, j, w, x, cos, sin, ema, c=None, pos=None, seg=None):
        """Layer slot j on its weights `w` (a block, or a dict of the same
        names) -> (x, the MoE layer's new load EMA and metrics, or None,
        None).  With a cache `c` (this layer's leaves, written in place)
        it is prefill, or one decode step at `pos`; without one it is the
        training forward, attention masked to `seg`'s segments."""
        cfg = self.cfg
        h = rmsnorm(w["ln1"], x, cfg.norm_eps)
        if self.pattern[j][0] == "mamba":
            if pos is None:
                out, new = mb.mamba(w, h, cfg, impl=self.impl)
            else:
                out, new = mb.mamba_decode(w, c, h, cfg)
            for k, v in new.items():
                c[k].copy_(v)
            x = x + out
        else:
            q, k, v = attn.qkv(w, h, cfg, cos, sin)
            if pos is not None:
                attn.cache_update(c["k"], c["v"], k, v, pos)
                o = attn.decode_attention(q, c["k"], c["v"], pos + 1,
                                          impl=self.impl)
            else:
                if c is not None:
                    L = x.shape[1]
                    c["k"][:, :L] = k.to(c["k"].dtype)
                    c["v"][:, :L] = v.to(c["v"].dtype)
                o = attn.full_attention(q, k, v, causal=True,
                                        impl=self.impl, segment_ids=seg)
            x = x + attn.out_proj(w, o)
        if "router" in w:
            h = rmsnorm(w["ln2"], x, cfg.norm_eps)
            out, st, met = moel.moe(w, {"load_ema": ema}, h, cfg,
                                    impl=self.impl)
            return x + out, st["load_ema"], met
        if "wg" in w:
            x = x + mlpl.mlp(w, rmsnorm(w["ln2"], x, cfg.norm_eps))
        return x, None, None

    def _blocks(self, x, cos, sin, state, cache=None, pos=None, seg=None,
                params=None):
        """All layers -> (x, the new model state, the MoE metrics
        {"moe_imbalance", "moe_drop_frac" (means), "router_gap"
        (minimum)}, {} without MoE).  With a cache: prefill when pos is
        None, else one decode step, each layer's cache leaves written in
        place.  Without: the training forward on `params` (the module's
        parameter names), no cache, each layer under
        `torch.utils.checkpoint` when `cfg.remat == "layer"` and autograd
        records."""
        cfg = self.cfg
        new_ema, mets = {}, []
        for i, layer in enumerate(self.layers):
            g, j = divmod(i, self.period)
            key = f"slot_{j:02d}"
            ema = state[key]["load_ema"][g] if "router" in layer else None
            if cache is not None:
                c = {k: v[g] for k, v in cache[key].items()}
                x, ema, met = self._layer(j, layer, x, cos, sin, ema, c, pos)
            else:
                w = {name: params[f"layers.{i}.{name}"]
                     for name in layer.keys()}
                args = (j, w, x, cos, sin, ema, None, None, seg)
                x, ema, met = (checkpoint(self._layer, *args,
                                          use_reentrant=False)
                               if cfg.remat == "layer"
                               and torch.is_grad_enabled()
                               else self._layer(*args))
            if met is not None:
                new_ema.setdefault(key, []).append(ema)
                mets.append(met)
        metrics = {}
        if mets:
            for name in ("moe_imbalance", "moe_drop_frac"):
                metrics[name] = torch.stack([m[name] for m in mets]).mean()
            metrics["router_gap"] = torch.stack(
                [m["router_gap"] for m in mets]).min()
        return x, {key: {"load_ema": torch.stack(v)}
                   for key, v in new_ema.items()}, metrics

    @torch.no_grad()
    def prefill(self, state, cache, tokens):
        """tokens [B, L] (L <= the cache's max_len) -> (last-position
        logits [B, vocab], new state, cache with positions [0, L)
        written)."""
        cfg = self.cfg
        B, L = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
        cos, sin = self._angles(positions)
        x, state, self.metrics = self._blocks(x, cos, sin, state, cache)
        x = rmsnorm(self.final_norm, x[:, -1:], cfg.norm_eps)
        return self._logits(x)[:, 0], state, cache

    @torch.no_grad()
    def decode_step(self, state, cache, tokens, pos):
        """tokens [B, 1], pos [B] int32 -> (logits [B, vocab], new state,
        cache with position pos[b] of row b written)."""
        cfg = self.cfg
        x = self.embed[tokens]
        cos, sin = self._angles(pos[:, None])
        x, state, self.metrics = self._blocks(x, cos, sin, state, cache,
                                              pos)
        x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)[:, 0], state, cache

    # ---------------------------------------------------------- training
    def loss(self, state, batch, params=None):
        """The masked next-token cross entropy of `batch` -> (loss, new
        state, metrics {"loss", and the MoE layers' "moe_imbalance",
        "moe_drop_frac" (means) and "router_gap" (minimum)})."""
        cfg = self.cfg
        if any(mixer == "mamba" for mixer, _ in self.pattern):
            raise NotImplementedError(
                f"{cfg.name}: training a Mamba2 mixer needs a backward for "
                "K6 (ssd_scan), ROADMAP P13e")
        P = dict(self.named_parameters()) if params is None else params
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        x = P["embed"][tokens]
        if "vis_embed" in batch:                       # VLM stub frontend
            x = x + batch["vis_embed"].to(cfg.compute_dtype)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
        cos, sin = self._angles(positions)
        x, new_state, metrics = self._blocks(
            x, cos, sin, state, seg=batch.get("segment_ids"), params=P)
        x = rmsnorm(P["final_norm"], x, cfg.norm_eps)
        w_out = P["embed"].t() if cfg.tie_embeddings else P["unembed"]
        loss = xent(x @ w_out, labels)
        return loss, new_state, {"loss": loss.detach(), **metrics}

def xent(logits, labels):
    """Masked next-token cross entropy (labels < 0 are padding), the JAX
    package's `_xent`: the float32 log-sum-exp of each row less the
    label's logit, summed over the unmasked positions over their count.
    The label's logit is a gather, which equals the JAX one-hot
    contraction bit for bit (one nonzero term)."""
    mask = labels >= 0
    lab = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = torch.gather(logits, -1, lab[..., None])[..., 0].float()
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp_min(1)
