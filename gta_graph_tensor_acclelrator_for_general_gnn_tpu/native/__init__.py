"""ctypes loader for the native preprocessing library.

The .so is never committed (it is built with -march=native, so a foreign
binary could SIGILL); it is compiled from the ``*.cpp`` sources with make
on first import, then validated by a tiny self-test against the numpy reference
before ``HAVE_NATIVE`` is set.  Everything falls back to the numpy paths
when native code is unavailable or fails the self-test."""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libgta_native.so")

_lib = None


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    srcs = [os.path.join(_DIR, f)
            for f in ("graphprep.cpp", "sampler.cpp", "cluster.cpp")]
    if (not os.path.exists(_SO)
            or any(os.path.getmtime(_SO) < os.path.getmtime(s)
                   for s in srcs)):
        if not _build():
            return None
    lib = ctypes.CDLL(_SO)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.gta_sort_by_receiver.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p]
    lib.gta_degrees.argtypes = [i32p, i32p, ctypes.c_int64, f64p, f64p]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.gta_label_prop.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, i32p]
    lib.gta_label_prop.restype = ctypes.c_int32
    lib.gta_sample_epoch.argtypes = [
        i64p, i32p, ctypes.c_int64,                     # row_ptr, senders, n
        i32p, ctypes.c_int32, ctypes.c_int32,           # seeds, batch, S
        i32p, ctypes.c_int32,                           # fanouts, n_hops
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,  # cap_n, e_pad, seed
        i32p, i32p, u8p, f32p, i32p, u8p]               # outputs
    _lib = lib
    return lib


def _self_test() -> bool:
    """Native outputs must match the numpy reference on a tiny graph before
    the library is trusted (catches a stale/foreign binary)."""
    try:
        r = np.array([2, 0, 1, 0, 2], np.int32)
        s = np.array([1, 2, 0, 0, 1], np.int32)
        order = sort_by_receiver_native(r, 3, _checked=False)
        if order is None or list(r[order]) != sorted(r.tolist()):
            return False
        degs = degrees_native(s, r, 3, _checked=False)
        if degs is None:
            return False
        out_deg, in_deg = degs
        ok = (np.array_equal(out_deg, [2., 2., 1.])
              and np.array_equal(in_deg, [2., 1., 2.]))
        return bool(ok)
    except Exception:
        return False


def _validate_ids(n_node, *arrays):
    """Reject out-of-range node ids before they reach raw C pointers (a
    malformed id corrupts heap memory there; numpy would only mis-answer)."""
    for a in arrays:
        if len(a) and (a.min() < 0 or a.max() >= n_node):
            raise ValueError(
                f"node id out of range [0, {n_node}): "
                f"min={a.min()}, max={a.max()}")


def sort_by_receiver_native(receivers, n_node, _checked=True):
    """Stable counting-sort permutation by receiver, or None."""
    lib = _load()
    if lib is None:
        return None
    receivers = np.ascontiguousarray(receivers, np.int32)
    if _checked:
        _validate_ids(n_node + 1, receivers)  # n_node = dump row is legal
    ne = len(receivers)
    counts = np.zeros(n_node + 2, np.int64)
    order = np.zeros(ne, np.int64)
    lib.gta_sort_by_receiver(receivers, ne, n_node, counts, order)
    return order


def degrees_native(senders, receivers, n_node, _checked=True):
    lib = _load()
    if lib is None:
        return None
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    if _checked:
        _validate_ids(n_node, senders)
        _validate_ids(n_node, receivers)
    out_deg = np.zeros(n_node, np.float64)
    in_deg = np.zeros(n_node, np.float64)
    lib.gta_degrees(senders, receivers, len(senders), out_deg, in_deg)
    return out_deg, in_deg


def label_prop_native(row_ptr, nbrs, n_node, max_iter=20, seed=0):
    """Async label-propagation over a symmetrized CSR (see cluster.cpp).
    Returns int32 labels (representative node ids, uncompacted) or None."""
    lib = _load()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    nbrs = np.ascontiguousarray(nbrs, np.int32)
    _validate_ids(n_node, nbrs)
    assert len(row_ptr) == n_node + 1 and row_ptr[-1] == len(nbrs)
    labels = np.empty(n_node, np.int32)
    lib.gta_label_prop(row_ptr, nbrs, n_node, int(max_iter),
                       seed & (2**64 - 1), labels)
    return labels


def sample_epoch_native(row_ptr, senders, seeds, fanouts, batch,
                        cap_nodes, e_pad, seed):
    """Parallel native epoch sampler (see sampler.cpp).

    ``seeds`` is [S * batch] global ids; returns the stacked batch dict the
    scanned train step consumes (models/train.train_sampled_scan), or None
    when native code is unavailable.  Per-batch RNG is deterministic in
    (seed, batch index) — independent of thread schedule."""
    lib = _load()
    if lib is None:
        return None
    n_node = len(row_ptr) - 1
    seeds = np.ascontiguousarray(seeds, np.int32)
    _validate_ids(n_node, seeds)
    S = len(seeds) // batch
    assert S * batch == len(seeds), (len(seeds), batch)
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    senders = np.ascontiguousarray(senders, np.int32)
    fan = np.ascontiguousarray(fanouts, np.int32)
    out_src = np.empty((S, e_pad), np.int32)
    out_dst = np.empty((S, e_pad), np.int32)
    out_mask = np.empty((S, e_pad), np.uint8)
    out_w = np.empty((S, e_pad), np.float32)
    out_ids = np.empty((S, cap_nodes), np.int32)
    out_seed = np.empty((S, cap_nodes), np.uint8)
    lib.gta_sample_epoch(
        row_ptr, senders, n_node, seeds, batch, S, fan, len(fan),
        cap_nodes, e_pad, seed & (2**64 - 1),
        out_src, out_dst, out_mask, out_w, out_ids, out_seed)
    return dict(
        senders=out_src, receivers=out_dst, mask=out_mask.astype(bool),
        weight=out_w, ids=out_ids, seed=out_seed.astype(bool))


# resolved at import time, after all entry points above are defined
HAVE_NATIVE = _load() is not None and _self_test()
