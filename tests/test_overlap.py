"""parallel.overlap: scheduled-HLO async-collective window parser.

The real input is the compiled sharded train step's ``as_text()``
(chip_smoke.py --four-cards prints its report); these tests pin the
parser's semantics on a hand-written scheduled module so regressions in the
regexes fail fast without a device.
"""
import pytest

from gta_graph_tensor_acclelrator_for_general_gnn_tpu.parallel.overlap import (
    overlap_report)

HLO = """HloModule jit_step, is_scheduled=true, num_partitions=8

ENTRY %main_spmd (param.1: f32[4096,512]) -> f32[4096,512] {
  %param.1 = f32[4096,512]{1,0} parameter(0)
  %slice-start = ((f32[4096,512]), f32[2048,512], s32[]) slice-start(%param.1)
  %slice-done = f32[2048,512]{1,0} slice-done(%slice-start)
  %all-to-all-start = ((f32[2048,512]), f32[2048,512]) all-to-all-start(%slice-done), channel_id=1
  %fusion.1 = f32[4096,512]{1,0} fusion(%param.1), kind=kOutput, backend_config={"window_config":{"estimated_cycles":"12345"}}
  %custom-call.2 = f32[4096,512]{1,0} custom-call(%fusion.1), custom_call_target="__gpu$xla.gpu.triton", backend_config={"estimated_cycles":"777"}
  %all-to-all-done = f32[2048,512]{1,0} all-to-all-done(%all-to-all-start)
  %all-reduce.3 = f32[4096,512]{1,0} all-reduce(%custom-call.2), channel_id=2
  ROOT %add.9 = f32[4096,512]{1,0} add(%all-to-all-done, %all-reduce.3)
}
"""


def test_overlap_report_finds_async_window():
    r = overlap_report(HLO)
    assert r["n_async"] == 1
    p = r["pairs"][0]
    assert p["collective"] == "all-to-all"
    assert p["window_insts"] == 2
    assert p["window_compute"] == 2
    assert p["window_hist"] == {"fusion": 1, "custom-call": 1}
    # both straddled compute insts carry estimated_cycles
    assert p["overlapped_est_cycles"] == 12345 + 777
    assert r["overlapped_cycles"] == 13122
    # the sync all-reduce outside the window is counted as non-overlapped
    assert r["n_sync_collectives"] == 1


def test_overlap_report_requires_schedule():
    with pytest.raises(AssertionError):
        overlap_report("HloModule m\nENTRY %e () -> f32[] {}")
