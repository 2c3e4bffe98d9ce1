"""Fault-tolerant checkpointing (PyTorch port of the JAX package's
`checkpoint`): atomic writes, last-k retention, resume.

Layout: <dir>/step_<N>/shard_<p>.npz (one file per process) plus a DONE
marker written after the arrays are flushed; a crash mid-write leaves
no DONE marker and restore falls back to the previous complete step.
The tree's structure is encoded in flattened key paths, dict keys joined
by "||" (e.g. "params||blocks||slot_00||mixer||wq"), as the JAX package
writes them: a train state saved by either package restores in the
other.  Leaves are saved as numpy arrays (bfloat16 as float32: numpy
has no bfloat16) and restored into the dtype and device of the
template's leaves.

The JAX package's `reshard` places a tree onto a new `jax.sharding.Mesh`
after a pod is lost; the port runs on one card and has no counterpart
(ROADMAP).
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from ..models.module import leaves

SEP = "||"


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _flatten(tree) -> dict:
    return {SEP.join(str(k) for k in path): _numpy(leaf)
            for path, leaf in leaves(tree)}


def _unflatten(node, flat: dict, path=()):
    if isinstance(node, dict):
        return {k: _unflatten(v, flat, path + (k,))
                for k, v in node.items()}
    arr = flat[SEP.join(str(k) for k in path)]
    if isinstance(node, torch.Tensor):
        return torch.as_tensor(np.asarray(arr)).to(node.device, node.dtype)
    return arr


def save(ckpt_dir: str, step: int, tree, process: int = 0,
         keep_last: int = 3) -> str:
    """Atomic per-process save; returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    os.makedirs(step_dir, exist_ok=True)
    flat = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=".tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    final = os.path.join(step_dir, f"shard_{process:05d}.npz")
    os.replace(tmp, final)                       # atomic
    with open(os.path.join(step_dir, "DONE"), "w") as f:
        f.write(str(step))
    _gc(ckpt_dir, keep_last)
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "DONE")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            process: int = 0):
    """Restore into the structure, dtypes and devices of `template` ->
    (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}",
                        f"shard_{process:05d}.npz")
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(template, flat), step


def _gc(ckpt_dir: str, keep_last: int):
    done = sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name))
        and os.path.exists(os.path.join(ckpt_dir, name, "DONE")))
    for s in done[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
