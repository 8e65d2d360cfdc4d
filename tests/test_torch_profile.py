"""The port's step cost profiler (``metrics_tpu_torch/obs/profile.py``) against
the contracts of the JAX package's ``tests/analysis/test_profile.py``: a
row per registry entry with JAX's keys, collective bytes off the recording
communicator, per-tier wall rows for the ladder entries, an atomic write to
the port's own file, and the CLI (``--out``, an unknown entry failing
loudly), which never writes the repo-root ``COST_PROFILE.json``.
"""
import hashlib
import json
import os
import pathlib

import pytest

torch = pytest.importorskip("torch")

from metrics_tpu_torch.analysis import graph_audit as G  # noqa: E402
from metrics_tpu_torch.analysis import registry as R  # noqa: E402
from metrics_tpu_torch.analysis.__main__ import main as cli  # noqa: E402
from metrics_tpu_torch.obs import profile as prof  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BY_NAME = {e.name: e for e in R.REGISTRY}
JAX_ROW_KEYS = {"entry", "flops", "bytes_accessed", "collectives", "collective_bytes", "collective_bytes_total", "wall"}


def test_fused_collection_cost_row():
    row = prof.profile_entry(BY_NAME["fused_stat_collection"], reps=4, device="cpu")
    assert JAX_ROW_KEYS <= set(row) and "device_ms" not in row  # the card's time on CUDA only
    assert row["entry"] == "fused_stat_collection"
    assert row["bytes_accessed"] > 0 and row["flops"] == 0  # no matmul in a stat-scores step
    assert row["collectives"] == {"all-reduce": 1}
    _, _, trace = R.run_entry_step(BY_NAME["fused_stat_collection"], G.MirrorWorld(4), torch.device("cpu"))
    independent = G.collective_payload_bytes(trace)
    assert row["collective_bytes"] == {"all-reduce": independent["all-reduce"]} and row["collective_bytes_total"] > 0
    wall = row["wall"]
    assert wall["reps"] == 4 and 0 < wall["p50_ms"] <= wall["p99_ms"]


def test_zero_collective_entry_reports_empty_payload():
    row = prof.profile_entry(BY_NAME["bucketed_rank_step"], reps=2, device="cpu")
    assert row["collectives"] == {} and row["collective_bytes_total"] == 0 and row["bytes_accessed"] > 0


def test_ladder_entry_gets_per_tier_wall_rows():
    row = prof.profile_entry(BY_NAME["ladder_served_update"], reps=2, tier_reps=2, device="cpu")
    assert sorted(int(t) for t in row["tiers"]) == [8, 32, 128]
    for tier_row in row["tiers"].values():
        assert tier_row["reps"] == 2 and 0 < tier_row["p50_ms"] <= tier_row["p99_ms"]


def test_recompile_only_entry_still_gets_a_row():
    row = prof.profile_entry(BY_NAME["mean_update_stability"], reps=2, device="cpu")
    assert row["bytes_accessed"] > 0 and row["wall"]["reps"] == 2 and row["collectives"] == {}


def test_flops_count_a_matmul_step():
    """FlopCounterMode is the port's flop model: a 64x32 by 32x16 product is
    2 * 64 * 32 * 16 flops."""
    from torch.utils.flop_counter import FlopCounterMode

    a, b = torch.ones(64, 32), torch.ones(32, 16)
    with FlopCounterMode(display=False) as fc:
        G.record_step(lambda: a @ b)
    assert fc.get_total_flops() == 2 * 64 * 32 * 16


def test_profile_doc_renders_and_writes_atomically(tmp_path):
    doc = prof.profile_registry((BY_NAME["fused_stat_collection"],), reps=2, device="cpu")
    table = prof.render_table(doc)
    assert "fused_stat_collection" in table and "wall p50" in table
    out = tmp_path / "cost.json"
    path = prof.write_profile(doc, str(out))
    loaded = json.loads(out.read_text())
    assert path == str(out) and loaded["entries"][0]["entry"] == "fused_stat_collection"
    assert loaded["platform"] == "cpu" and "FlopCounterMode" in loaded["cost_model"]
    assert [p.name for p in tmp_path.iterdir()] == ["cost.json"]  # no temporary left behind
    assert prof.default_profile_path() == str(ROOT / "metrics_tpu_torch" / "analysis" / "COST_PROFILE.json")


def _root_profile_digest():
    return hashlib.sha256((ROOT / "COST_PROFILE.json").read_bytes()).hexdigest()


def test_cli_profile_subcommand(tmp_path, capsys):
    before = _root_profile_digest()
    out = tmp_path / "cost.json"
    rc = cli(["profile", "--device", "cpu", "--entry", "fused_stat_collection", "--reps", "2", "--out", str(out)])
    assert rc == 0
    assert json.loads(out.read_text())["entries"][0]["collectives"] == {"all-reduce": 1}
    assert "fused_stat_collection" in capsys.readouterr().out
    assert _root_profile_digest() == before


def test_cli_profile_unknown_entry_fails_loudly(capsys):
    assert cli(["profile", "--device", "cpu", "--entry", "no_such_entry", "--no-write"]) == 1
    assert "unknown entr(y/ies) ['no_such_entry']" in capsys.readouterr().err


def test_cli_profile_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    existed = os.path.exists(prof.default_profile_path())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["profile", "--entry", "fused_stat_collection"])
    assert os.path.exists(prof.default_profile_path()) == existed  # a refused run writes nothing
