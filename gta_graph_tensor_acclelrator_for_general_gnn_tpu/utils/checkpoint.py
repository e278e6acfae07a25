"""Checkpoint / resume for training state, as one numpy ``.npz`` per step.

The reference has no computation checkpointing at all (SURVEY §5: 'absent';
its only resume is the GA's CSV memo).  Real training needs it: save the
TrainState pytree (params + optimiser state + step) and restore it into a
freshly built template to continue.  The file holds the pytree's leaves in
flattening order plus the treedef's text, which restore checks against the
template's, so a checkpoint never loads into a differently shaped state.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import jax
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def _path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}.npz")


def save_state(path: str, state, step: Optional[int] = None,
               max_to_keep: int = 3) -> int:
    """Save a TrainState (or any pytree of arrays).  Returns the step saved.
    Keeps the newest ``max_to_keep`` checkpoints under ``path``."""
    s = int(step if step is not None else jax.device_get(state.step))
    leaves, treedef = jax.tree.flatten(state)
    os.makedirs(path, exist_ok=True)
    arrays = {f"leaf_{i:05d}": np.asarray(jax.device_get(l))
              for i, l in enumerate(leaves)}
    tmp = _path(path, s) + ".tmp.npz"
    np.savez(tmp, __treedef__=np.asarray(str(treedef)), **arrays)
    os.replace(tmp, _path(path, s))
    steps = sorted(_steps(path))
    for old in steps[:-max_to_keep]:
        os.remove(_path(path, old))
    return s


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return [int(m.group(1)) for f in os.listdir(path)
            if (m := _NAME.match(f))]


def restore_state(path: str, template, step: Optional[int] = None):
    """Restore into the structure of ``template`` (e.g. a freshly built
    TrainState).  ``step=None`` restores the latest."""
    s = step if step is not None else latest_step(path)
    if s is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    leaves, treedef = jax.tree.flatten(template)
    with np.load(_path(path, s)) as z:
        if str(z["__treedef__"]) != str(treedef):
            raise ValueError("checkpoint structure does not match the "
                             "template's")
        arrays = [z[f"leaf_{i:05d}"] for i in range(len(leaves))]
    out = []
    for a, t in zip(arrays, leaves):
        if a.shape != np.shape(t):
            raise ValueError(f"leaf shape {a.shape} != template's "
                             f"{np.shape(t)}")
        out.append(jax.numpy.asarray(a, dtype=getattr(t, "dtype", a.dtype)))
    return jax.tree.unflatten(treedef, out)


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return max(steps) if steps else None
