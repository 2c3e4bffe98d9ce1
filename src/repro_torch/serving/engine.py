"""Batched serving engine: continuous-batching decode over a fixed-slot
KV cache, prefill admission and per-request completion (PyTorch port of
the JAX package's `serving/engine.py`, with its semantics):

* `max_slots` sequences share the cache [.., slots, max_len, ..]; a
  request is admitted into a free slot by `model.prefill` on a batch of
  1 over that slot's lane of the cache;
* `Request.out` holds the token prefill emits plus at most
  `max_new_tokens` decode tokens; an EOS from prefill ends the request
  at admission and its slot is never occupied;
* every decode step runs in lock-step over ALL `max_slots` lanes,
  inactive ones included, and a request ends on EOS, on its decode
  budget, or when its position reaches `max_len - 1`;
* tokens are the greedy argmax, ties to the first index.

The model contract: `init_cache_specs(batch, max_len)`, `state_specs()`,
`prefill(state, cache, tokens [1, L]) -> (logits [1, V], state, cache)`
(an encoder-decoder model, `cfg.family == "encdec"`, also takes
`enc_feats`: the engine passes zero frame features [1, n_enc_frames,
d_model] float32, the JAX engine's stub, so its cross attention adds
nothing) and `decode_step(state, cache, tokens [B, 1], pos [B]) -> (logits
[B, V], state, cache)`, where prefill and decode write the cache
tensors they are given in place and return the model state anew.
Admission hands prefill views of the slot's lane, `c[:, slot:slot + 1]`
of every cache leaf [layers, slots, ...], so it writes back exactly
that lane: the KV cache of an attention layer (and the self and cross
caches of an encoder-decoder layer, whose sequence extents are max_len
and the frame count), and the SSM state
[layers, slots, H, N, P] and the three conv tails [layers, slots, 3,
width] of a Mamba2 layer, which its prefill overwrites whole (the
lock-step decode leaves garbage in idle lanes).  `pos` matters to
attention only; the `max_len - 1` stop rule holds for every model.

The model state, as in the JAX engine: a leaf whose spec names a
"batch" axis holds per-sequence state, and admission hands prefill
that slot's lane of it and writes the lane back; any other leaf is
engine-global and prefill's new value replaces it whole.  The MoE load
EMAs are global, so every prefill and every decode step (idle lanes
included, fed their last token at an unadvanced position) moves the
routing of every later call.  `mstate=None` starts from zeros of
`state_specs()` (the empty state for a model without one).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import module


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 8
    max_len: int = 512
    eos_id: int = 1
    # decode-step budget per request: `Request.out` carries the
    # prefill-emitted first token plus at most max_new_tokens decode
    # tokens
    max_new_tokens: int = 64


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [L] int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _state_lane_axes(model, mstate):
    """Per-leaf slot-lane axis of the model-state tree (-1: global), from
    the "batch" axis of its `state_specs()`; None (no slicing anywhere)
    when the model is stateless, has no specs, or `mstate` does not have
    their structure (a caller's own state opts out of lane handling)."""
    if not mstate or not hasattr(model, "state_specs"):
        return None
    specs = model.state_specs()
    if not specs or [p for p, _ in module.leaves(specs)] != [
            p for p, _ in module.leaves(mstate)]:
        return None
    return module.tree_map(
        lambda s: s.axes.index("batch") if "batch" in s.axes else -1, specs)


def _lane_index(ndim: int, ax: int, slot: int) -> tuple:
    idx = [slice(None)] * ndim
    idx[ax] = slice(slot, slot + 1)
    return tuple(idx)


class ServingEngine:
    def __init__(self, model, cfg: ServeConfig,
                 mstate: Optional[dict] = None):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        if mstate is None:
            specs = (model.state_specs() if hasattr(model, "state_specs")
                     else {})
            mstate = module.zeros(specs, self.device)
        self.mstate = mstate
        self._state_lane = _state_lane_axes(model, mstate)
        # the stub frontend's frame features of an encoder-decoder model
        mcfg = getattr(model, "cfg", None)
        self._feats = ((1, mcfg.n_enc_frames, mcfg.d_model)
                       if getattr(mcfg, "family", None) == "encdec"
                       else None)
        self.cache = module.zeros(
            model.init_cache_specs(cfg.max_slots, cfg.max_len), self.device)
        self.pos = np.zeros((cfg.max_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * cfg.max_slots
        self.last_tok = np.zeros((cfg.max_slots,), np.int64)

    # ------------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        lane = module.tree_map(lambda c: c[:, slot:slot + 1], self.cache)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                                 device=self.device)
        # lane leaves of the state see only their own lane; global leaves
        # (the MoE load EMAs) pass whole and come back whole
        ms = self.mstate
        if self._state_lane is not None:
            ms = module.tree_map2(
                lambda c, ax: c if ax < 0 else c[_lane_index(c.ndim, ax,
                                                             slot)],
                self.mstate, self._state_lane)
        if self._feats is not None:
            feats = torch.zeros(self._feats, dtype=torch.float32,
                                device=self.device)
            logits, ms_new, _ = self.model.prefill(ms, lane, prompt, feats)
        else:
            logits, ms_new, _ = self.model.prefill(ms, lane, prompt)
        if self._state_lane is None:
            self.mstate = ms_new
        else:
            def write(c, new, ax):
                if ax < 0:
                    return new
                c[_lane_index(c.ndim, ax, slot)] = new
                return c
            self.mstate = module.tree_map2(write, self.mstate, ms_new,
                                           self._state_lane)
        tok = int(torch.argmax(logits[0]))
        req.out.append(tok)
        if tok == self.cfg.eos_id or self.cfg.max_new_tokens <= 0:
            req.done = True
            return True
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_tok[slot] = tok
        return True

    def step(self) -> bool:
        """One lock-step batched decode over every slot; False (and no
        decode) when no slot is active."""
        if not any(r is not None for r in self.active):
            return False
        toks = torch.as_tensor(self.last_tok[:, None], device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.mstate, self.cache = self.model.decode_step(
            self.mstate, self.cache, toks, pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[i] += 1
            tok = int(nxt[i])
            req.out.append(tok)
            self.last_tok[i] = tok
            # out[0] is the prefill-emitted token: only decode-emitted
            # tokens count against the max_new_tokens budget
            if (tok == self.cfg.eos_id
                    or len(req.out) - 1 >= self.cfg.max_new_tokens
                    or self.pos[i] >= self.cfg.max_len - 1):
                req.done = True
                self.active[i] = None
        return True

    def run(self, requests: List[Request], max_steps: int = 10_000):
        """Admit + decode until all requests complete."""
        pending = list(requests)
        steps = 0
        while (pending or any(self.active)) and steps < max_steps:
            while pending and self._free_slot() is not None:
                self.admit(pending.pop(0))
            self.step()
            steps += 1
        return requests
