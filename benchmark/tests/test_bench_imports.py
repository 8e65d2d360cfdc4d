"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
references import nothing of the program; top-level module names are
compared whole, since ``metrics_tpu_torch`` begins with ``metrics_tpu``."""
import ast
import pathlib

from bench_helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "metrics_tpu"}


def imported_top_levels(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


def offenders(files, forbidden):
    return {str(p.relative_to(ROOT)): sorted(imported_top_levels(p) & forbidden) for p in files if imported_top_levels(p) & forbidden}


def test_benchmark_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 20
    assert offenders(files, FORBIDDEN) == {}


def test_references_import_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").rglob("*.py"))
    assert files
    assert offenders(files, FORBIDDEN | {"metrics_tpu_torch"}) == {}


def test_the_port_passes_the_first_check():
    files = sorted((ROOT / "metrics_tpu_torch").rglob("*.py"))
    assert len(files) > 50
    assert offenders(files, FORBIDDEN) == {}


def test_the_check_tells_the_names_apart(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom metrics_tpu import Accuracy\n")
    good = tmp_path / "good.py"
    good.write_text("import metrics_tpu_torch\nfrom metrics_tpu_torch.ops import histogram\nimport jaxtyping\n")
    assert imported_top_levels(bad) & FORBIDDEN == {"jax", "metrics_tpu"}
    assert imported_top_levels(good) & FORBIDDEN == set()
