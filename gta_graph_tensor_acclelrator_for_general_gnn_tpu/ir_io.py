"""Op-graph YAML serialisation in the reference's schema.

The reference defines every model as a YAML list of op dicts
(``template/op_template.yaml:1-19``; generator ``vTCAD/GraphOP/
genGraphOP.py:gen_one_op:4-25``): OP_NO, COMP_TYPE, TYPE, ORDER, INPUT
(input_g_list/input_g_num/input_nong_list/input_nong_num/input_size/
feature_number/size_per_feature) and OUTPUT (output_list/output_number/
size_per_feature), with sizes in bytes (feature count x 4).

This module round-trips our :class:`~.ir.OpGraph` through that schema so
reference model files can be imported and our graphs exported for
inspection.  Semantic information the reference never carried (weight
shapes, SF names, constants — needed for *numerical* execution) rides in an
``EXTRA`` key that reference-schema consumers can ignore; importing a file
without EXTRA synthesises weight names from op ids.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from . import ir

_KIND_TO_REF = {ir.SCATTER: "scatter", ir.GATHER: "gather",
                ir.APPLY_EDGE: "applyedge", ir.APPLY_NODE: "applynode"}
_REF_TO_KIND = {v: k for k, v in _KIND_TO_REF.items()}
BYTES = 4


def to_yaml(graph: ir.OpGraph, n_node: int = 0, n_edge: int = 0) -> str:
    """Serialise to the reference op-list schema (YAML string)."""
    ops_out: List[Dict[str, Any]] = []
    consumers: Dict[int, List[int]] = {op.op_id: [] for op in graph.ops}
    for u, v in graph.edges():
        consumers[u].append(v)
    for oid in graph.topo_order():
        op = graph.by_id[oid]
        g_list = [i for i in op.inputs if i >= 0]
        nong = [i for i in op.inputs if i < 0]
        rows_in = n_node if op.in_domain == ir.NODE else n_edge
        rows_out = n_node if op.out_domain == ir.NODE else n_edge
        in_w = sum(graph.width_of(i) for i in op.inputs) if op.inputs \
            else graph.in_width
        d = {
            "OP_NO": op.op_id,
            "COMP_TYPE": op.compute,
            "TYPE": _KIND_TO_REF[op.kind],
            "ORDER": op.order,
            "INPUT": {
                "input_g_list": g_list,
                "input_g_num": len(g_list),
                "input_nong_list": nong,
                "input_nong_num": len(nong),
                "input_size": rows_in * in_w * BYTES,
                "feature_number": in_w,
                "size_per_feature": rows_in * BYTES,
            },
            "OUTPUT": {
                "output_list": sorted(consumers[oid]),
                "output_number": len(consumers[oid]),
                "size_per_feature": rows_out * BYTES,
                "feature_number": op.out_width,
            },
        }
        if op.extra:
            extra = dict(op.extra)
            if "weight" in extra:
                extra["weight"] = list(extra["weight"])
            d["EXTRA"] = extra
        ops_out.append(d)
    import yaml   # optional dependency, needed only to serialise
    return yaml.safe_dump(ops_out, sort_keys=False)


def from_yaml(text: str, name: str = "imported",
              in_width: Optional[int] = None) -> ir.OpGraph:
    """Parse the reference op-list schema back into an OpGraph.

    Files without EXTRA (plain reference files) get synthesised weight specs
    for MM ops (in/out widths from the byte sizes) and default SF kinds.
    """
    import yaml   # optional dependency, needed only to parse
    raw = yaml.safe_load(text)
    ops: List[ir.Op] = []
    for d in raw:
        kind = _REF_TO_KIND[d["TYPE"].strip().lower()]
        compute = d["COMP_TYPE"].strip().upper()
        inp = d.get("INPUT", {})
        outp = d.get("OUTPUT", {})
        inputs = list(inp.get("input_g_list", []) or [])
        inputs += list(inp.get("input_nong_list", []) or [])
        out_w = outp.get("feature_number")
        if out_w is None:
            # reference files carry bytes; features = input_size / rows
            out_w = max(int(outp.get("size_per_feature", BYTES)) // BYTES, 1)
        extra = dict(d.get("EXTRA", {}))
        if "weight" in extra:
            extra["weight"] = tuple(extra["weight"])
        elif compute == ir.MM:
            iw = int(inp.get("feature_number", out_w))
            extra["weight"] = (f"{name}_w{d['OP_NO']}", iw, int(out_w))
        if compute == ir.SF and "sf" not in extra:
            extra["sf"] = "relu"
        ops.append(ir.Op(
            op_id=int(d["OP_NO"]), kind=kind, compute=compute,
            order=d.get("ORDER", "R"), inputs=inputs,
            out_width=int(out_w), extra=extra))
    if in_width is None:
        first = [o for o in ops if ir.X_INPUT in o.inputs]
        in_width = int(raw[0]["INPUT"].get("feature_number", 1)) if raw else 1
        if first:
            in_width = int(
                raw[[o.op_id for o in ops].index(first[0].op_id)]
                ["INPUT"].get("feature_number", in_width))
    return ir.OpGraph(name=name, ops=ops, in_width=in_width)


def save(graph: ir.OpGraph, path: str, n_node: int = 0, n_edge: int = 0):
    with open(path, "w") as f:
        f.write(to_yaml(graph, n_node, n_edge))


def load(path: str, name: Optional[str] = None,
         in_width: Optional[int] = None) -> ir.OpGraph:
    import os
    with open(path) as f:
        return from_yaml(f.read(),
                         name or os.path.splitext(os.path.basename(path))[0],
                         in_width)
