"""External hardware/tuning configuration (the reference's
``hardware_info.yaml`` — vTCAD/code/hardware_info.yaml:1-6 carries buffer
size, PE parallelism and bandwidth; its fusion-pattern table :11-69 maps to
the kernel pattern matchers here).

A JSON/YAML file (path via ``GTA_HW_CONFIG`` env var or
:func:`load_hw_config`) overrides the built-in defaults:

    vmem_budget_bytes:  on-chip buffer bound of the reference's buffer model
                        (compiler/schedule.tile_is_feasible; the reference's
                        2 MB Buffer_Size).  Unset: no bound.
    vmem_regions:       fractional caps {weight, node, edge} of the budget
                        (reference isFlexibleBuffer W .75/N .5/E .5,
                        compiler.py:73-75,95-99)
    tile_palette:       list of [block_rows, block_cols, tile_edges, path]
                        entries swept by the tuner
    ici_gbps / dcn_gbps: per-device link egress inside a host / per-host
                        egress between hosts, for the scaling model
                        (parallel/scaling.py)

``configs/reference_gta.json`` is the reference's simulated accelerator.
With no file, there is no buffer bound, and the link bandwidth is that of
the device JAX runs on, from :data:`DEVICE_PEAKS`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, Optional, Tuple

# Published peaks of the devices this program is measured on, keyed by
# jax ``device_kind``.  NVIDIA H100 SXM data sheet (dense rates, at the
# 700 W power limit): 3.35 TB/s HBM3, 989 TFLOP/s bf16, 67 TFLOP/s float32
# outside the tensor cores, NVLink 900 GB/s per card = 450 GB/s each way.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": dict(hbm_gbps=3350.0, bf16_tflops=989.0,
                                  f32_tflops=67.0, link_gbps=450.0),
}


def device_peaks(device_kind: Optional[str] = None) -> Dict[str, float]:
    """Peaks of ``device_kind`` (default: the first JAX device).  A device
    missing from :data:`DEVICE_PEAKS` is an error, not a default."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    if device_kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       "add them to hwconfig.DEVICE_PEAKS with their source")
    return DEVICE_PEAKS[device_kind]


@dataclasses.dataclass(frozen=True)
class HwConfig:
    buffer_budget_bytes: Optional[int] = None
    buffer_regions: Tuple[float, float, float] = (1.0, 0.5, 0.5)  # W, N, E
    tile_palette: Optional[Tuple[tuple, ...]] = None   # None = built-in
    ici_gbps: Optional[float] = None
    dcn_gbps: Optional[float] = None

    def palette(self):
        from .compiler import schedule as S
        from .tune.search import TILE_PALETTE
        if self.tile_palette is None:
            return TILE_PALETTE
        out = []
        for entry in self.tile_palette:
            br, bc, te = int(entry[0]), int(entry[1]), int(entry[2])
            path = entry[3] if len(entry) > 3 else S.PATH_CSR
            out.append(S.TileConfig(br, bc, te, path))
        return tuple(out)

    def max_tile(self, feat_width: int, dtype_bytes: int = 4):
        """Largest square tile feasible under the buffer budget and region
        caps — the reference's buffer-maximal tile (its binary_search
        under the 2 MB buffer, compiler.py:67-131).  None when no budget is
        configured or even 128^2 does not fit."""
        from .compiler import schedule as S
        if self.buffer_budget_bytes is None:
            return None
        best = None
        n = 128
        while n <= 1 << 16:
            tc = S.TileConfig(n, n, min(n, 1024))
            if not S.tile_is_feasible(tc, feat_width,
                                      self.buffer_budget_bytes, dtype_bytes):
                break
            best = tc
            n *= 2
        return best

    def derived_palette(self, feat_width: int, dtype_bytes: int = 4):
        """Palette derived from the buffer-maximal tile: scale sweep
        {1, .5, .25} of the max square plus rectangular variants (the
        reference sweeps tile scale factors relative to the maximal tile,
        code/enumeration.py:93-99) plus the non-CSR entries.  Falls back to
        the static palette without a budget or when even 128^2 does not
        fit."""
        from .compiler import schedule as S
        mx = self.max_tile(feat_width, dtype_bytes)
        if mx is None:
            return self.palette()
        seen, out = set(), []

        def add(br, bc, te):
            br, bc, te = max(br, 128), max(bc, 128), max(te, 128)
            tc = S.TileConfig(br, bc, te, S.PATH_CSR)
            if tc.key() not in seen and S.tile_is_feasible(
                    tc, feat_width, self.buffer_budget_bytes, dtype_bytes):
                seen.add(tc.key())
                out.append(tc)

        m = mx.block_rows
        for scale in (1.0, 0.5, 0.25):
            n = max(int(m * scale) // 128 * 128, 128)
            add(n, n, min(n, 1024))
            add(n, n, min(n // 2, 1024))
        add(m // 2, m, min(m, 1024))        # wide-C (gather-heavy shapes)
        add(m, m // 2, min(m, 1024))        # wide-R
        for tc in self.palette():
            if tc.path != S.PATH_CSR:
                out.append(tc)
        return tuple(out)


def load_hw_config(path: Optional[str] = None) -> HwConfig:
    """Read the config file (JSON; YAML when pyyaml is available).  With no
    path and no ``GTA_HW_CONFIG`` env var, returns defaults.  Parsed
    configs are cached per path — feasibility checks call this per tile
    per candidate schedule (thousands of times per tune)."""
    path = path or os.environ.get("GTA_HW_CONFIG")
    if not path:
        return HwConfig()
    return _load_hw_config_cached(path)


@functools.lru_cache(maxsize=16)
def _load_hw_config_cached(path: str) -> HwConfig:
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        import yaml
        data = yaml.safe_load(text)
    kw: Dict = {}
    if "vmem_budget_bytes" in data:
        kw["buffer_budget_bytes"] = int(data["vmem_budget_bytes"])
    if "vmem_regions" in data:
        r = data["vmem_regions"]
        kw["buffer_regions"] = (float(r.get("weight", 1.0)),
                                float(r.get("node", 0.5)),
                                float(r.get("edge", 0.5))) \
            if isinstance(r, dict) else tuple(float(v) for v in r)
    if "tile_palette" in data:
        kw["tile_palette"] = tuple(tuple(e) for e in data["tile_palette"])
    for key in ("ici_gbps", "dcn_gbps"):
        if key in data:
            kw[key] = float(data[key])
    return HwConfig(**kw)
