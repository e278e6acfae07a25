"""Measured-latency harness (replaces the reference's cycle-count simulator
as the source of truth for schedule fitness and reported numbers —
vTCAD/code/simulator.py returns simulated cycles; here we time real runs).

Times are host-clock seconds around work that ends in
``jax.block_until_ready``: JAX returns before the device finishes, so a
timing without it measures the enqueue.  Compilation happens in the warmup
calls and is never inside a timed call.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Tuple

import jax
import numpy as np


def card_info() -> dict:
    """The GPU's name and power limit as nvidia-smi reports them: a card
    set below its maximum power runs slower under load, so every number
    taken on it carries both."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    name, limit = (v.strip() for v in out[0].split(","))
    return {"card": name, "power_limit": limit}


def time_fn(
    fn: Callable,
    *args,
    iters: int = 50,
    warmup: int = 2,
    **kwargs,
) -> Tuple[float, float]:
    """Median and best wall-clock seconds per call of ``fn(*args)``.

    The first call compiles; ``warmup`` calls are discarded.  Each timed call
    blocks on the result, so dispatch overhead is included (it is part of the
    real serving latency).
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.min(times))


def time_apply(apply: Callable, params, g, x, *, iters: int = 20,
               warmup: int = 2) -> float:
    """Median seconds per call of a lowered ``apply(params, g, x)``, jitted
    once.  Programs from ``lower_schedule`` / ``Model.make_apply`` expose
    their graph data (``apply.captures``), which rides as a jit ARGUMENT
    here instead of being embedded as constants."""
    cap = getattr(apply, "captures", None)
    if cap is not None:
        f = jax.jit(apply.inner)
        args = (params, g, x, cap)
    else:
        f = jax.jit(apply)
        args = (params, g, x)
    med, _ = time_fn(f, *args, iters=iters, warmup=warmup)
    return med
