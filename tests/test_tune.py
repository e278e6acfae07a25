"""Autotuner tests (CPU: measured latencies are meaningless but the machinery
— candidate generation, legality, memoization, GA operators — must work)."""
import jax
import jax.numpy as jnp
import numpy as np

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as S
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import init_params, lower
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import (
    GeneticTuner, Memo, autotune)

from conftest import small_graph


def _setup(rng, network="GCN", n=64, e=300, iw=16, ow=8, **kw):
    s, r = small_graph(rng, n=n, e=e)
    hg = gta.build_host_graph(s, r, n, add_self_loops=True, symmetric_norm=True)
    og = gta.build_op_graph(network, iw, ow, **kw)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(n, iw)).astype(np.float32))
    return hg, hg.to_device(), og, params, x


def test_autotune_gcn_returns_valid_best(rng, tmp_path):
    hg, g, og, params, x = _setup(rng)
    res = autotune(og, hg, params, g, x,
                   memo_path=str(tmp_path / "memo.csv"), iters=2)
    assert np.isfinite(res.latency_s)
    assert len(res.trials) >= 2
    # best schedule must produce correct numbers
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion import (
        lower_schedule)
    ref = lower(og)(params, g, x)
    out = lower_schedule(og, res.best, hg)(params, g, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_memo_roundtrip(tmp_path):
    p = str(tmp_path / "m.csv")
    m = Memo(p)
    m.put("k1", 1.5e-4)
    m2 = Memo(p)
    assert m2.get("k1") == 1.5e-4
    assert m2.get("nope") is None


def test_genetic_tuner_gat(rng, tmp_path):
    hg, g, og, params, x = _setup(rng, "GAT", iw=12, ow=8, heads=2)
    tuner = GeneticTuner(og, hg, memo_path=str(tmp_path / "memo.csv"),
                         max_generations=2, n_offspring=4, iters=2)
    res = tuner.search(params, g, x)
    assert np.isfinite(res.latency_s)
    # decode covers pattern genomes
    pattern_trials = [m for m in res.trials
                      if any(len(b) == 14 for b in m.schedule.blocks)]
    assert pattern_trials, "pattern super-block never evaluated"
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion import (
        lower_schedule)
    ref = lower(og)(params, g, x)
    out = lower_schedule(og, res.best, hg)(params, g, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_genome_decode_always_legal(rng):
    hg, g, og, params, x = _setup(rng, "GAT", iw=8, ow=8, heads=2)
    tuner = GeneticTuner(og, hg)
    rnd = np.random.default_rng(0)
    n = len(tuner.free)
    checked = 0
    for _ in range(50):
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import Genome
        gen = Genome(tuple(int(b) for b in rnd.integers(0, 2, n)),
                     tuple(int(t) for t in rnd.integers(0, 5, 3)),
                     bool(rnd.integers(0, 2)),
                     bool(rnd.integers(0, 2)))
        sched = tuner.decode(gen)
        if sched is None:
            continue
        checked += 1
        assert S.partition_is_legal_with_patterns(
            og, [list(b) for b in sched.blocks])
    assert checked > 10


def test_hw_config_file(tmp_path):
    """External hardware config overrides the buffer budget / palette
    (hardware_info.yaml parity)."""
    import json as _json
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.hwconfig import (
        load_hw_config)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)

    p = tmp_path / "hw.json"
    p.write_text(_json.dumps(dict(
        vmem_budget_bytes=2 * 2**20,
        vmem_regions=dict(weight=1.0, node=0.5, edge=0.5),
        tile_palette=[[128, 128, 256], [256, 256, 512, "stream"]],
        hbm_gbps=128.0)))
    cfg = load_hw_config(str(p))
    assert cfg.buffer_budget_bytes == 2 * 2**20
    pal = cfg.palette()
    assert pal[0].block_rows == 128 and pal[0].path == S.PATH_CSR
    assert pal[1].path == S.PATH_STREAM
    # reference-scale 2MB budget rejects large tiles, accepts small ones
    assert not S.tile_is_feasible(S.TileConfig(4096, 4096, 1024), 128,
                                  cfg.buffer_budget_bytes)
    assert S.tile_is_feasible(S.TileConfig(128, 128, 256), 32,
                              cfg.buffer_budget_bytes)
    # no file: no buffer bound at all
    assert load_hw_config(None).buffer_budget_bytes is None
    assert S.tile_is_feasible(S.TileConfig(1 << 14, 1 << 14, 4096), 512)


def test_genome_encode_decode_roundtrip(rng):
    """encode() must be a right-inverse of decode(): re-decoding a lifted
    schedule reproduces the same blocks and tile keys (the warm-start
    transfer path, cli tune --stack)."""
    hg, g, og, params, x = _setup(rng, "GAT", iw=8, ow=8, heads=2)
    tuner = GeneticTuner(og, hg)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import Genome
    import random as _random
    r = _random.Random(3)
    n = len(tuner.free)
    nt = tuner._n_tile_genes
    checked = 0
    for _ in range(40):
        gen = Genome(tuple(r.randint(0, 1) for _ in range(n)),
                     tuple(r.randrange(len(tuner.palette))
                           for _ in range(nt)),
                     r.random() < 0.7, r.random() < 0.5)
        sched = tuner.decode(gen)
        if sched is None:
            continue
        sched2 = tuner.decode(tuner.encode(sched))
        assert sched2 is not None
        assert sched2.blocks == sched.blocks
        # tile keys must match on pattern blocks (XLA blocks carry no genes)
        pat = [i for i, t in enumerate(sched.tiles) if t.path != S.PATH_XLA]
        for i in pat:
            assert sched2.tiles[i].key() == sched.tiles[i].key(), i
        checked += 1
    assert checked >= 5, checked


def test_warm_start_seeds_present(rng):
    hg, g, og, params, x = _setup(rng, "GAT", iw=8, ow=8, heads=2)
    base = GeneticTuner(og, hg)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import Genome
    sched = base.decode(Genome((1,) * len(base.free),
                               (1,) * base._n_tile_genes, True, True))
    assert sched is not None
    warm = GeneticTuner(og, hg, warm_start=[sched])
    seeds = warm._seeds()
    enc = warm.encode(sched)
    assert enc in seeds
    assert warm.decode(enc).key() == sched.key()


def test_derived_palette_feasible(rng):
    """derived_palette entries must all be buffer-feasible and include the
    buffer-maximal tile (reference enumeration.py:93-99 scale sweep)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.hwconfig import (
        HwConfig)
    cfg = HwConfig(buffer_budget_bytes=4 * 2**20)
    pal = cfg.derived_palette(feat_width=128)
    csr = [t for t in pal if t.path == S.PATH_CSR]
    assert csr, pal
    mx = cfg.max_tile(128)
    assert any(t.block_rows == mx.block_rows for t in csr)
    for t in csr:
        assert S.tile_is_feasible(t, 128, cfg.buffer_budget_bytes)
    # a bigger budget must allow at least as large a maximal tile
    big = HwConfig(buffer_budget_bytes=16 * 2**20).max_tile(128)
    assert big.block_rows >= mx.block_rows


def test_tuner_derive_palette(rng):
    hg, g, og, params, x = _setup(rng, "GAT", iw=8, ow=8, heads=2)
    t = GeneticTuner(og, hg, derive_palette=True)
    assert len(t.palette) >= 3
    scheds = [s for s in map(t.decode, t._seeds()) if s is not None]
    assert any(tc.path != S.PATH_XLA for s in scheds for tc in s.tiles)


def test_pareto_frontier():
    """pareto keeps only non-dominated (latency, traffic) points, sorted by
    latency with strictly decreasing traffic."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune.search import (
        Measurement, TuneResult)
    mk = lambda lat, tr: Measurement(schedule=None, latency_s=lat, traffic=tr)
    trials = [mk(1.0, 100), mk(2.0, 50),   # frontier
              mk(3.0, 60),                 # dominated by (2.0, 50)
              mk(1.5, 100),                # dominated by (1.0, 100)
              mk(4.0, 10)]                 # frontier
    res = TuneResult(best=None, latency_s=1.0, trials=trials)
    front = [(m.latency_s, m.traffic) for m in res.pareto]
    assert front == [(1.0, 100), (2.0, 50), (4.0, 10)]
