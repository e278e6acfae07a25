"""CLI driver tests (in-process; conftest pins the CPU platform)."""
import json

from gta_graph_tensor_acclelrator_for_general_gnn_tpu.cli import main


def test_cli_train_json(capsys, tmp_path):
    rc = main(["train", "--dataset", "tiny", "--network", "GCN",
               "--epochs", "8", "--hidden", "16", "--json",
               "--ckpt", str(tmp_path / "ck")])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["dataset"] == "tiny" and "train_acc" in out
    assert out["ckpt_step"] == 8


def test_cli_train_with_schedule(capsys, tmp_path):
    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    og = gta.build_op_graph("GCN", 16, 16)
    part = S.max_fusion_partition(og)
    spec = {"blocks": [list(b) for b in part],
            "tiles": [[256, 256, 1, "stream"] if len(b) >= 2
                      else [256, 256, 512, "xla"] for b in part]}
    p = tmp_path / "sched.json"
    p.write_text(json.dumps(spec))
    rc = main(["train", "--dataset", "tiny", "--network", "GCN",
               "--epochs", "8", "--hidden", "16", "--json",
               "--schedule", str(p)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "train_acc" in out


def test_cli_node_reorder_cluster(capsys):
    """--node-reorder cluster: train still converges on the relabelled
    graph (features/labels/masks permuted consistently)."""
    rc = main(["train", "--dataset", "tiny", "--network", "GCN",
               "--epochs", "30", "--hidden", "16", "--json",
               "--node-reorder", "cluster"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["node_reorder"] == "cluster"
    # training is permutation-invariant: the relabelled run must match the
    # unpermuted baseline (0.6625 at these hyperparameters), not degrade
    assert out["train_acc"] > 0.6, out


def test_cli_bench_batched(capsys):
    """bench --batch B: block-diagonal serving composition; the CSR kernels
    and their XLA references are timed on the B*E-edge graph, and the line
    names the device it ran on."""
    rc = main(["bench", "--dataset", "tiny", "--hidden", "16",
               "--iters", "2", "--batch", "3", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch"] == 3
    for k in ("spmm_csr", "spmm_xla", "gat_csr", "gat_xla"):
        assert out[f"{k}_edges_per_s"] > 0
    assert out["device"]["platform"] == "cpu"


def test_cli_run_compiled(capsys):
    """run --compiled: the compile-only pick lowers and times end to end."""
    rc = main(["run", "--dataset", "tiny", "--network", "GAT",
               "--hidden", "16", "--heads", "2", "--iters", "2",
               "--compiled", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["latency_us"] > 0 and len(out["schedule"]) == 2
