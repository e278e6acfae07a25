"""Scaling-efficiency model sanity (parallel/scaling.py): the prediction
must exist and behave where no multi-device measurement does."""
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.hwconfig import HwConfig
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.parallel.scaling import (
    overlap_fraction, predicted_scaling)

RATE = 1.0e9        # an illustrative single-device edge rate
E = 114_505_698
NVLINK = HwConfig(ici_gbps=450.0)   # one H100's NVLink, each way


def test_efficiency_bounds_and_ordering():
    plan = dict(n_shards=8, halo_bytes=477e6, hub_bytes=13e6,
                edge_balance=1.02)
    r = predicted_scaling(plan, edges_per_s_chip=RATE, n_edge=E, overlap=0.5,
                          hw=NVLINK)
    assert 0 < r["efficiency_no_overlap"] <= r["efficiency"] \
        <= r["efficiency_full_overlap"] <= 1.0 + 1e-9
    assert r["n_chips"] == 8
    # balance > 1 caps even the fully-overlapped efficiency
    assert r["efficiency_full_overlap"] <= 1 / 1.02 + 1e-9


def test_comm_bound_when_interconnect_is_slow():
    hw = HwConfig(ici_gbps=0.5)       # pathological interconnect
    plan = dict(n_shards=8, halo_bytes=477e6)
    r = predicted_scaling(plan, edges_per_s_chip=RATE, n_edge=E,
                          overlap=1.0, hw=hw)
    assert r["comm_bound"]
    assert r["efficiency"] < 0.8      # the 80% target correctly fails here


def test_2d_plan_uses_dcn_per_host():
    hw = HwConfig(ici_gbps=180.0, dcn_gbps=0.05)
    plan = dict(mesh=[2, 4], ici_bytes=600e6, dcn_bytes=67e6)
    r = predicted_scaling(plan, edges_per_s_chip=RATE, n_edge=E,
                          overlap=0.0, hw=hw)
    assert r["t_dcn_s"] > r["t_ici_s"]
    assert r["comm_bound"]


def test_saved_plans_predict_above_target():
    """Reddit-scale partition plans (exchange bytes as the 1-D 8-way and
    2x4 partitions of the 114.5M-edge community graph report them) predict
    >= 80% at 8 devices over NVLink-class links, even with no overlap."""
    plans = {
        "plan_1d_8": dict(n_shards=8, halo_bytes=477_233_152,
                          hub_bytes=13_074_432),
        "plan_2d_2x4": dict(mesh=[2, 4], ici_bytes=600e6, dcn_bytes=67e6),
    }
    hw = HwConfig(ici_gbps=450.0, dcn_gbps=50.0)
    for name, plan in plans.items():
        r = predicted_scaling(plan, edges_per_s_chip=RATE, n_edge=E,
                              overlap=0.0, hw=hw)
        assert r["efficiency"] >= 0.8, (name, r)


def test_default_link_needs_a_known_device():
    """Without a configured link bandwidth the model takes the device's
    from hwconfig.DEVICE_PEAKS — and refuses a device it has no peaks for
    (the CPU test backend)."""
    import pytest
    plan = dict(n_shards=8, halo_bytes=477e6)
    with pytest.raises(KeyError):
        predicted_scaling(plan, edges_per_s_chip=RATE, n_edge=E)


def test_overlap_fraction():
    assert overlap_fraction(dict(pairs=[])) == 0.0
    rep = dict(pairs=[dict(overlapped_est_cycles=50)],
               overlapped_cycles=100)
    assert overlap_fraction(rep) == 0.5
    assert overlap_fraction(dict(pairs=[dict(overlapped_est_cycles=5)],
                                 overlapped_cycles=0)) == 0.0


def test_multihost_driver_virtual_mesh():
    """train_multihost (the --multihost entry, parallel/multihost.py)
    degenerates to 1 host x N virtual chips and trains: the same SPMD
    code path a real pod runs per process."""
    import jax
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets \
        import load_dataset
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.parallel import (
        init_multihost, train_multihost)
    pid, pcount = init_multihost()       # idempotent single-process init
    assert (pid, pcount) == (0, 1)
    ds = load_dataset("tiny")
    loss, _ = train_multihost(ds, "GCN", hidden=32, epochs=15)
    import numpy as np
    assert np.isfinite(loss)
