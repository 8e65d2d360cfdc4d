"""Analysis tools of the port (counterpart of ``metrics_tpu/analysis/__init__.py``):
the machinery that keeps the port's invariants checked by code instead of
by reviewers.

- **AST lint** (:mod:`.lint` + ``analysis/rules/``): import purity (no CUDA
  at import), state discipline (``add_state`` declarations, ``template=`` on
  list states), concurrency discipline (named daemon threads, no callback
  under a lock, locks minted on the construction path) and contract
  discipline (env knobs through ``ops/_envtools.py``, durable writes through
  ``atomic_write_bytes``, gated health events). Per-line suppressions
  (``# graft-lint: disable=GL102``) and the port's own baseline
  (``analysis/lint_baseline.txt``) grandfather known findings. The JAX
  package's trace-safety rules (GL201-GL203) are not ported (ROADMAP D69).
- **Static lock order** (:mod:`.concurrency`): the lock-acquisition graph
  over ``metrics_tpu_torch/`` against the port's ``analysis/LOCK_ORDER.md``;
  the runtime witness (:mod:`.lockwitness`) checks the same ranks at run
  time.
- **Step-budget audit** (:mod:`.graph_audit` + :mod:`.registry`): each
  flagship path's step run under a recording communicator and a recorder
  of aten ops — collectives by kind, no float64, no read to the host, no
  value-shaped op — plus the capture-key recompilation audit (ROADMAP D66).
- **Cost profile** (``obs/profile.py``): per registry entry, flops, bytes,
  collective bytes and wall (and the card's time on CUDA).

Run them from the CLI (``python -m metrics_tpu_torch.analysis``). This
module imports no torch: the lint and lock passes are pure AST; the audit
imports torch when invoked.
"""
from metrics_tpu_torch.analysis.baseline import (
    apply_baseline,
    default_baseline_path,
    load_baseline,
    save_baseline,
)
from metrics_tpu_torch.analysis.lint import (
    Finding,
    lint_package,
    lint_paths,
    lint_source,
)
from metrics_tpu_torch.analysis.rules import ALL_RULES, rule_catalog

__all__ = [
    "ALL_RULES",
    "Finding",
    "apply_baseline",
    "default_baseline_path",
    "lint_package",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "rule_catalog",
    "save_baseline",
]
