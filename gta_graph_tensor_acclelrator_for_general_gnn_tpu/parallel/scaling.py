"""Predicted multi-device/multi-host scaling efficiency.

A roofline-style prediction of per-layer step time and scaling efficiency
per partition plan, from a single-device edge rate, the plan's per-device
exchange bytes (the partition plans' ``comm_report``), link bandwidths and
the comm/compute overlap the compiled schedule achieves
(:func:`overlap_fraction` over :func:`~.overlap.overlap_report`).  It plays
the role the reference's simulator played for its fictional chip
(vTCAD/code/start.py:57-58 always printed the headline predictive number);
a measured four-device step replaces it wherever one exists.

Model (per GNN layer, D shards):

  t_comp = (n_edge * balance / D) / edges_per_s_chip
  t_ici  = per-device link egress bytes / ici_gbps   (inside a host)
  t_dcn  = per-host egress bytes / dcn_gbps          (between hosts)
  t_comm = max(t_ici, t_dcn)                 (separate networks)
  t_step(ov) = ov * max(t_comp, t_comm) + (1 - ov) * (t_comp + t_comm)

  efficiency(ov) = (n_edge / edges_per_s_chip) / (D * t_step(ov))

``ov`` in [0, 1] is the overlapped fraction of the collective windows.
Both bounds (ov=0, ov=1) are reported so the prediction carries its own
uncertainty interval.
"""
from __future__ import annotations

from typing import Optional

from ..hwconfig import HwConfig, load_hw_config


def overlap_fraction(report: dict) -> float:
    """Overlap fraction from an ``overlap_report`` dict: the summed compute
    cycles the scheduler placed inside async collective windows, over the
    summed window span — 0.0 when no async collectives exist."""
    pairs = report.get("pairs", [])
    if not pairs:
        return 0.0
    hidden = sum(p.get("overlapped_est_cycles", 0) for p in pairs)
    span = report.get("overlapped_cycles", 0)
    if span <= 0:
        return 0.0
    return max(0.0, min(1.0, hidden / span))


def predicted_scaling(
    plan: dict,
    *,
    edges_per_s_chip: float,
    n_edge: int,
    overlap: float = 0.7,
    hw: Optional[HwConfig] = None,
) -> dict:
    """Predicted per-layer step time and scaling efficiency for one
    partition plan.

    ``plan``: a dict in the shape the partition builders report
    (PartitionedGraph.comm_report / Mesh2DPlan.comm_report):

      1-D (single host, D devices):
        n_shards, halo_bytes, hub_bytes (optional), edge_balance (optional)
      2-D (hosts x chips):
        mesh [Dh, Dc], ici_bytes, dcn_bytes, edge_balance (optional)

    ``edges_per_s_chip``: the measured single-device rate for this op at
    this feature width.
    ``overlap``: fraction of comm hidden under compute; pass
    :func:`overlap_fraction` of a measured schedule report for the
    evidence-backed value.  Returns a dict with t_comp/t_ici/t_dcn (s),
    efficiency at ``overlap`` and at both bounds.
    """
    hw = hw or load_hw_config()
    ici = hw.ici_gbps
    if ici is None:
        from ..hwconfig import device_peaks
        ici = device_peaks()["link_gbps"]
    balance = float(plan.get("edge_balance", 1.0))
    if "mesh" in plan:
        dh, dc = (int(v) for v in plan["mesh"])
        d = dh * dc
        ici_bytes = float(plan.get("ici_bytes", 0.0))
        dcn_bytes = float(plan.get("dcn_bytes", 0.0))
        t_ici = (ici_bytes / d) / (ici * 1e9)
        # DCN is a per-HOST resource: each host's NIC carries its chips'
        # inter-host traffic
        if hw.dcn_gbps is None:
            raise ValueError("a hosts x devices plan needs hw.dcn_gbps")
        t_dcn = (dcn_bytes / dh) / (hw.dcn_gbps * 1e9)
    else:
        d = int(plan["n_shards"])
        ici_bytes = float(plan.get("halo_bytes", 0.0)) + float(
            plan.get("hub_bytes", 0.0))
        t_ici = (ici_bytes / d) / (ici * 1e9)
        t_dcn = 0.0
    t_comp = (n_edge * balance / d) / edges_per_s_chip
    t_comm = max(t_ici, t_dcn)

    def step(ov: float) -> float:
        return ov * max(t_comp, t_comm) + (1.0 - ov) * (t_comp + t_comm)

    t1 = n_edge / edges_per_s_chip

    def eff(ov: float) -> float:
        return t1 / (d * step(ov))

    return dict(
        n_chips=d,
        t_comp_s=t_comp,
        t_ici_s=t_ici,
        t_dcn_s=t_dcn,
        overlap=overlap,
        t_step_s=step(overlap),
        efficiency=eff(overlap),
        efficiency_no_overlap=eff(0.0),
        efficiency_full_overlap=eff(1.0),
        comm_bound=t_comm > t_comp,
    )
