"""Comm/compute overlap evidence from a scheduled HLO module.

The reference has no distributed execution at all (SURVEY §2 "parallelism:
none"); its only overlap notion is the *simulated* unit-level concurrency of
the scoreboard (``vTCAD/code/simulator.py:223-244`` RAW/WAR credits letting
the memory unit run under compute).  Here overlap is real and verifiable:
when XLA's scheduler turns the halo ``all_to_all`` / hub ``all_gather`` /
gradient ``all_reduce`` into ``*-start``/``*-done`` pairs, it may place the
local-edge work (the CSR kernels and local XLA chains, which depend only on
``x_local``) between them, so the transfer rides under compute.

:func:`overlap_report` parses a *scheduled* post-optimization HLO dump
(``compiled.as_text()``) and, for every async start/done pair, reports what
the scheduler actually placed between the two: instruction count, opcode
histogram, and the summed cost-model ``estimated_cycles`` of the straddled
compute where the backend annotates it.  This is compiler evidence (the
schedule is what the device executes), not a "by dependence" claim.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

# ``%name = <type> opcode(...)`` — opcode is the first lowercase token after
# the result type; types/layouts never contain '('.
_INST = re.compile(r"^\s*(?:ROOT\s+)?%([\w.-]+)\s*=\s*[^=]*?\s([a-z][\w-]*)\(")
_CYCLES = re.compile(r'"estimated_cycles":"(\d+)"')
_OPERAND = re.compile(r"\(%([\w.-]+)")

# opcodes that are real work (vs bookkeeping) when straddled by a collective
_COMPUTE = {"fusion", "convolution", "custom-call", "dot", "while", "call",
            "dynamic-update-slice", "reduce", "sort", "scatter"}


def _computations(hlo_text: str) -> Dict[str, List[str]]:
    """Split a scheduled HLO dump into {computation name: [body lines]}."""
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for ln in hlo_text.splitlines():
        m = re.match(r"^(ENTRY\s+)?%?([\w.-]+)\s+\([^)]*\)\s*->.*\{", ln)
        if m:
            cur = m.group(2)
            comps[cur] = []
            continue
        if cur is not None:
            if ln.startswith("}"):
                cur = None
            else:
                comps[cur].append(ln)
    return comps


def overlap_report(hlo_text: str) -> dict:
    """Analyse a scheduled HLO module for async collective overlap.

    Returns ``{"pairs": [...], "n_async": int, "n_sync_collectives": int,
    "overlapped_cycles": int}`` where each pair entry carries the collective
    opcode, the straddled instruction count, an opcode histogram, and the
    summed ``estimated_cycles`` of straddled compute (0 when the backend
    writes no such annotation).
    Instructions are taken in SCHEDULE order (``is_scheduled=true`` modules
    list them in execution order), so "between start and done" is literally
    the window the transfer has to hide in.
    """
    assert "is_scheduled=true" in hlo_text, (
        "overlap_report needs a scheduled module (compiled.as_text())")
    pairs = []
    n_sync = 0
    for comp, lines in _computations(hlo_text).items():
        insts = []
        for ln in lines:
            m = _INST.match(ln)
            if m:
                insts.append((m.group(1), m.group(2), ln))
        name_to_idx = {n: i for i, (n, _, _) in enumerate(insts)}
        for i, (name, opc, ln) in enumerate(insts):
            if opc in ("all-to-all", "all-gather", "all-reduce",
                       "collective-permute", "reduce-scatter"):
                n_sync += 1
            if not opc.endswith("-start") or opc in (
                    "copy-start", "slice-start", "send-start", "recv-start"):
                continue
            kind = opc[: -len("-start")]
            if kind not in ("all-to-all", "all-gather", "all-reduce",
                            "collective-permute", "reduce-scatter"):
                continue
            # find the matching done by operand reference
            done_idx = None
            for j in range(i + 1, len(insts)):
                dn, dopc, dln = insts[j]
                if dopc == kind + "-done":
                    ops = _OPERAND.findall(dln)
                    if ops and ops[0] == name:
                        done_idx = j
                        break
            if done_idx is None:
                continue
            window = insts[i + 1: done_idx]
            hist: Dict[str, int] = {}
            cycles = 0
            for wn, wopc, wln in window:
                hist[wopc] = hist.get(wopc, 0) + 1
                if wopc in _COMPUTE:
                    mc = _CYCLES.search(wln)
                    if mc:
                        cycles += int(mc.group(1))
            pairs.append({
                "computation": comp,
                "collective": kind,
                "start": name,
                "window_insts": len(window),
                "window_compute": sum(
                    hist.get(k, 0) for k in _COMPUTE),
                "window_hist": hist,
                "overlapped_est_cycles": cycles,
            })
    return {
        "pairs": pairs,
        "n_async": len(pairs),
        "n_sync_collectives": n_sync,
        "overlapped_cycles": sum(p["overlapped_est_cycles"] for p in pairs),
    }
