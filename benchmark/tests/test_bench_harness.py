"""The harness on the CPU: every entry of ``BENCHMARK.json`` finds its files
by name, a configuration placed in a copy is found and run with no code
edited, every name and unit keeps to the allowed characters, and the pieces
of a run (inputs, the host read of values, the profiler summary, the
command's refusals) do what they say."""
import collections
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_helpers import ROOT, WORKLOADS, tiny_copy
from benchmark import run
from benchmark.harness import inputs as inputs_mod
from benchmark.harness import loop, profiling, program, roofline, spec

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_file_keeps_to_the_contract():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec.problems(DOC) == []
    assert DOC["paths"] == ["benchmark"] and DOC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert [w["name"] for w in DOC["workloads"]] == list(WORKLOADS)
    assert all(w["chips"] == 1 for w in DOC["workloads"])
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert set(e2e) == {"rows_per_s", "update_p95_ms", "compute_ms", "setup_s"}
    assert all(0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    assert {c["name"] for c in DOC["configs"]} == {w["config"] for w in DOC["workloads"]}
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmark/")
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    assert len(json.dumps(DOC)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files_by_name(workload):
    cell = spec.load_cell(workload, ROOT)
    assert cell.config_name == workload.split(".")[0] and cell.traffic_name == workload.split(".", 1)[1]
    assert set(cell.readers) == {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"rows_per_s", "update_p95_ms", "setup_s"} <= {m["name"] for m in cell.end_to_end}
    ref = cell.reference()
    assert callable(ref.expected) and callable(ref.observed)
    assert all(v >= 0 for v in cell.limits.values())


def test_a_new_configuration_in_a_copy_is_found_and_runs(tmp_path):
    root = tiny_copy(tmp_path)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "imagenet1k_cls.json").read_text())
    config.update(name="cifar100_cls", rows=300, classes=7, source="CIFAR-100 test set")
    (bench / "configs" / "cifar100_cls.json").write_text(json.dumps(config))
    shutil.copy(bench / "reference" / "imagenet1k_cls.py", bench / "reference" / "cifar100_cls.py")
    shutil.copy(bench / "limits" / "imagenet1k_cls.val_b1024.json", bench / "limits" / "cifar100_cls.val_b1024.json")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "cifar100_cls", "source": "CIFAR-100", "file": "benchmark/configs/cifar100_cls.json", "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "cifar100_cls.val_b1024", "config": "cifar100_cls", "traffic": "val_b1024", "chips": 1, "why": "a test"})
    for m in doc["per_layer"]:
        m.get("workloads", []).append("cifar100_cls.val_b1024")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.load_cell("cifar100_cls.val_b1024", root, bench)
    assert cell.config["classes"] == 7
    for trace in (False, True):
        result, lines, _ = run.run_cell(cell, 5, 0.05, trace, "cpu", time.perf_counter())
        assert result["correct"] is True and result["attempted"] >= 1
        assert list(result)[-1] == "checks" and len(lines) == len(result["checks"])
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}


NEW_DATA_KIND = '''
import torch


def make_rows(config, g, device):
    n, c = int(config["rows"]), int(config["classes"])
    scores = torch.rand((n, c), generator=g, device=device) ** float(config["data"]["power"])
    return (scores / scores.sum(dim=1, keepdim=True), torch.randint(0, c, (n,), generator=g, device=device)), 1
'''

NEW_REFERENCE = '''
import numpy as np
import torch


def expected(inputs, members, control=False):
    preds, target = inputs.args
    out = []
    for name in sorted(members):
        k = int(members[name]["args"].get("top_k") or 1)
        acc = float((torch.topk(preds, k, dim=1).indices == target[:, None]).any(dim=1).double().mean())
        out += [acc, acc, acc]  # MinMaxMetric: raw, max, min, each epoch from a reset
    return {"acc": np.asarray(out)}


def observed(values, members):
    # the collection lifts a member's dict of values to its own keys
    return {"acc": np.asarray([float(values[key]) for key in ("raw", "max", "min")])}
'''


def _digests(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_data_kind_and_wrapper_are_found_and_run_with_no_file_edited(tmp_path):
    root = tiny_copy(tmp_path)
    bench = root / "benchmark"
    before = _digests(root)
    (bench / "data" / "powered_scores.py").write_text(NEW_DATA_KIND)
    config = {"name": "cifar10_cls", "source": "CIFAR-10 test set", "rows": 200, "classes": 10,
              "data": {"kind": "powered_scores", "power": 3.0},
              "members": {"acc3": {"metric": "Accuracy", "args": {"num_classes": "${classes}", "top_k": 3}}}}
    (bench / "configs" / "cifar10_cls.json").write_text(json.dumps(config))
    traffic = {"name": "minmax_b64", "batch_items": 64, "wrap": {"metric": "MinMaxMetric", "args": {}}}
    (bench / "traffic" / "minmax_b64.json").write_text(json.dumps(traffic))
    (bench / "reference" / "cifar10_cls.minmax_b64.py").write_text(NEW_REFERENCE)
    (bench / "limits" / "cifar10_cls.minmax_b64.json").write_text(json.dumps({"limits": {"acc_gap": 1e-6}}))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "cifar10_cls", "source": "CIFAR-10", "file": "benchmark/configs/cifar10_cls.json", "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "cifar10_cls.minmax_b64", "config": "cifar10_cls", "traffic": "minmax_b64", "chips": 1, "why": "a test"})
    for m in doc["per_layer"]:
        m.get("workloads", []).append("cifar10_cls.minmax_b64")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.load_cell("cifar10_cls.minmax_b64", root, bench)
    for trace in (False, True):
        result, lines, _ = run.run_cell(cell, 2 ** 31 + 11, 0.05, trace, "cpu", time.perf_counter())
        assert result["correct"] is True and result["attempted"] >= 1, lines
    after = _digests(root)
    assert {p for p in before if before[p] != after[p]} == {pathlib.Path("BENCHMARK.json")}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_on_the_cpu_is_correct_and_reports_its_metrics(workload, tmp_path):
    root = tiny_copy(tmp_path)
    cell = spec.load_cell(workload, root, root / "benchmark")
    result, lines, record = run.run_cell(cell, 2 ** 31 + 3, 0.05, False, "cpu", time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    rows = inputs_mod.make_inputs(cell.config, cell.traffic, 1, "cpu", root / "benchmark").rows
    assert record["rows"] == record["epochs"] * rows
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_inputs_keep_their_sizes_for_every_seed():
    config = json.loads((ROOT / "benchmark" / "configs" / "imagenet1k_cls.json").read_text())
    config.update(rows=1000, classes=5)
    traffic = {"batch_items": 300, "row_inputs": {"slice_ids": {"kind": "zipf_ids", "count": 16, "zipf_exponent": 1.0}}}
    sizes = inputs_mod.generator("zipf_ids").sizes(1000, 16, 1.0)
    assert sum(sizes) == 1000 and sizes == sorted(sizes, reverse=True)
    a = inputs_mod.make_inputs(config, traffic, 2 ** 31 + 9, "cpu")
    b = inputs_mod.make_inputs(config, traffic, 2 ** 40, "cpu")
    c = inputs_mod.make_inputs(config, traffic, 2 ** 31 + 9, "cpu")
    assert a.batches == b.batches == [(0, 300), (300, 600), (600, 900), (900, 1000)]
    ids_a, ids_b = a.kwargs["slice_ids"], b.kwargs["slice_ids"]
    assert torch.bincount(ids_a, minlength=16).tolist() == torch.bincount(ids_b, minlength=16).tolist() == sizes
    assert torch.equal(a.args[0], c.args[0]) and not torch.equal(a.args[0], b.args[0])


def test_pixel_scores_keep_their_shares():
    config = json.loads((ROOT / "benchmark" / "configs" / "deepglobe_road.json").read_text())
    config.update(tiles=4, tile_side=256)
    data = inputs_mod.make_inputs(config, {"batch_items": 1}, 3, "cpu")
    preds, target = data.args
    fg = target == 1
    assert target.dtype == torch.uint8 and preds.dtype == torch.float32
    assert data.batches[:2] == [(0, 256 * 256), (256 * 256, 2 * 256 * 256)]
    assert abs(float(fg.float().mean()) - 0.045) < 0.005
    assert float(preds[fg].min()) >= 0.2
    assert abs(float((preds[~fg] < 1 / 99).float().mean()) - (0.9 + 0.1 * (1 / 99) ** 0.5)) < 0.01


def test_values_come_to_the_host_in_their_structure():
    Pair = collections.namedtuple("Pair", "per_slice global_value")
    value = {"a": torch.tensor(0.5), "b": [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])],
             "c": Pair([torch.tensor(1.0), torch.tensor(2.0)], torch.tensor(7, dtype=torch.int64))}
    host = loop.to_host(value)
    assert float(host["a"]) == 0.5 and [x.tolist() for x in host["b"]] == [[1.0, 2.0], [3.0, 4.0]]
    assert isinstance(host["c"], Pair) and [float(x) for x in host["c"].per_slice] == [1.0, 2.0]
    assert float(host["c"].global_value) == 7.0


def test_profile_summary_on_a_made_up_segment():
    seg = {
        "ranges": [("update", 0, 10), ("update", 10, 20), ("drain", 20, 40), ("compute", 40, 60), ("reset", 60, 70)],
        "device": [("binned_counters_kernel", 2, 8), ("elementwise_kernel", 8, 12), ("histogram_kernel", 25, 30),
                   ("reduce_kernel", 45, 50), ("fill_kernel", 65, 75)],
        "first_batch": 2,
    }
    got = profiling.summarize([seg], {key: m.NAMES for key, m in roofline.kernels().items()})
    assert got["window_s"] == pytest.approx(70e-6) and got["updates"] == 2
    assert got["busy_s"] == pytest.approx((10 + 5 + 5 + 5) * 1e-6)
    assert got["kernel_s"] == pytest.approx({"k1": 6e-6, "k2": 5e-6})
    assert got["torch_ops_s"] == pytest.approx(4e-6)  # the elementwise kernel; not the compute's or the reset's
    # the gaps 0-2, 12-25, 30-45 and 50-65, split by the host's ranges
    assert dict(got["idle_gaps"]) == pytest.approx({"update": 10e-6, "drain": 15e-6, "compute": 15e-6, "reset": 5e-6})
    assert got["device_ops"][0] == ["binned_counters_kernel", pytest.approx(6e-6)]


def test_forbidden_modules_are_compared_by_whole_top_level_names():
    assert program.forbidden_loaded(["metrics_tpu_torch", "metrics_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert program.forbidden_loaded(["jax.numpy", "metrics_tpu.ops", "flax"]) == ["flax", "jax.numpy", "metrics_tpu.ops"]


def test_the_command_prints_nothing_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", WORKLOADS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 2 and proc.stdout == ""


def test_the_command_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_readers_leave_out_what_they_cannot_read():
    cell = spec.load_cell(WORKLOADS[0], ROOT)
    empty = {"profile": None, "work": {}, "device_name": "cpu", "host_update_s": [], "member_updates": 0, "replays": 0}
    for m in cell.per_layer:
        assert cell.readers[m["name"]](empty) is None
    assert np.isfinite(cell.readers["update_p95_ms"]({"update_ms": [1.0, 2.0, 3.0]}))


def test_member_updates_count_each_compute_group_once():
    import metrics_tpu_torch as mtt

    coll = mtt.MetricCollection({name: getattr(mtt, cls)(num_classes=3, average="macro", device="cpu")
                                 for name, cls in (("f1", "F1Score"), ("prec", "Precision"), ("rec", "Recall"))})
    preds, target = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1]]), torch.tensor([0, 2])
    for _ in range(3):
        coll.update(preds, target)
    # the first update runs all three and forms one group; the next two run its head only
    assert len(coll._groups) == 1
    assert program.member_updates(coll) == 3
