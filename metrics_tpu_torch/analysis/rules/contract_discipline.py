"""Contract-discipline rules (counterpart of
``metrics_tpu/analysis/rules/contract_discipline.py``), GL5xx: the port's
cross-cutting runtime
contracts have single owner modules — these rules keep every other module
routed through them.

- ``GL501``: ``os.environ``/``os.getenv`` read outside ``ops/_envtools.py``.
  Every knob shares one contract — resolution at call time, memoized parse,
  malformed values warn ONCE and fall back — implemented exactly once
  (:class:`metrics_tpu_torch.ops._envtools.EnvParse`). A stray ``os.environ.get``
  re-grows the hand-rolled warn-once bugs that module exists to kill.
  ``utilities/backend.py`` is allow-listed: the bootstrap must read/write
  the environment before the package (and ``_envtools`` itself) is safely
  importable.
- ``GL502``: a write-mode ``open()`` outside ``resilience/snapshot.py``.
  Durable artifacts go through ``atomic_write_bytes`` (tmp + fsync +
  rename + dir fsync) — a bare ``open(path, "w")`` can tear on crash, the
  exact failure mode the flight recorder and snapshot layer are built to
  survive. Read-mode opens are untouched.
- ``GL503``: ``record_degradation(...)`` emitted from a loop body with no
  conditional gate. Cadence-rate paths (serve loops, publisher passes,
  drift checks) emit health events every iteration unless gated by an
  episode/condition — the bounded event ring then holds nothing but the
  spam (the flight recorder's ``min_interval_s`` episode gate is the
  canonical fix). ``except`` handlers count as gated: an error path is
  already conditional.
"""
import ast
from typing import Iterator, Optional, Tuple

from metrics_tpu_torch.analysis.lint import Finding, ModuleSource
from metrics_tpu_torch.analysis.rules._common import dotted_parts

# the env contract's single implementation + the pre-import bootstrap
_ENV_OWNER_MODULES = (
    "metrics_tpu_torch/ops/_envtools.py",
    "metrics_tpu_torch/utilities/backend.py",
)
# the atomic-write contract's single implementation
_WRITE_OWNER_MODULES = ("metrics_tpu_torch/resilience/snapshot.py",)

_WRITE_MODE_CHARS = frozenset("wax+")


class EnvReadOutsideEnvtools:
    rule_id = "GL501"
    name = "contract-env-read"
    description = (
        "`os.environ`/`os.getenv` read outside ops/_envtools.py — route knobs through "
        "EnvParse/WarnOnce (call-time resolution, memoized parse, warn-once fallback)"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        if module.relpath in _ENV_OWNER_MODULES:
            return
        for node in ast.walk(module.tree):
            parts = dotted_parts(node) if isinstance(node, ast.Attribute) else None
            if parts == ("os", "environ"):
                yield module.finding(
                    self.rule_id,
                    node,
                    "`os.environ` read outside the env-contract owner — declare the knob "
                    "as an `ops/_envtools.EnvParse` so resolution, memoization, and the "
                    "malformed-value warn-once cannot drift from the other knobs",
                )
            elif (
                isinstance(node, ast.Call)
                and dotted_parts(node.func) == ("os", "getenv")
            ):
                yield module.finding(
                    self.rule_id,
                    node,
                    "`os.getenv` outside the env-contract owner — declare the knob as an "
                    "`ops/_envtools.EnvParse` (call-time resolution + warn-once fallback)",
                )


class BareWriteOpen:
    rule_id = "GL502"
    name = "contract-bare-write"
    description = (
        "write-mode `open()` bypassing resilience/snapshot.py::atomic_write_bytes — a "
        "bare write can tear on crash; durable artifacts go tmp+fsync+rename"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        if module.relpath in _WRITE_OWNER_MODULES:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            parts = dotted_parts(node.func)
            if parts != ("open",):
                continue
            mode = self._literal_mode(node)
            if mode is not None and _WRITE_MODE_CHARS & set(mode):
                yield module.finding(
                    self.rule_id,
                    node,
                    f"`open(..., {mode!r})` — write through "
                    "`resilience/snapshot.py::atomic_write_bytes` (tmp + fsync + rename "
                    "+ dir fsync) so a crash mid-write cannot tear the artifact",
                )

    @staticmethod
    def _literal_mode(call: ast.Call) -> Optional[str]:
        mode: Optional[ast.AST] = None
        if len(call.args) >= 2:
            mode = call.args[1]
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return mode.value
        return None


class UngatedHealthEventInLoop:
    rule_id = "GL503"
    name = "contract-ungated-health-event"
    description = (
        "`record_degradation(...)` in a loop body with no conditional gate — cadence-"
        "rate paths must gate health emission behind an episode/condition or the "
        "bounded event ring holds nothing but spam"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        yield from self._walk(module, module.tree, in_loop=False, gated=False)

    def _walk(
        self, module: ModuleSource, node: ast.AST, in_loop: bool, gated: bool
    ) -> Iterator[Finding]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a nested def's body is not lexically "in" the enclosing loop
            in_loop, gated = False, False
        if isinstance(node, (ast.While, ast.For, ast.AsyncFor)):
            for child in ast.iter_child_nodes(node):
                yield from self._walk(module, child, in_loop=True, gated=False)
            return
        if isinstance(node, ast.If):
            yield from self._walk(module, node.test, in_loop, gated)
            for stmt in node.body + node.orelse:
                yield from self._walk(module, stmt, in_loop, gated=True)
            return
        if isinstance(node, ast.ExceptHandler):
            # an error path is already conditional
            for child in ast.iter_child_nodes(node):
                yield from self._walk(module, child, in_loop, gated=True)
            return
        if isinstance(node, ast.Call) and in_loop and not gated:
            parts = dotted_parts(node.func)
            if parts is not None and parts[-1] == "record_degradation":
                yield module.finding(
                    self.rule_id,
                    node,
                    "unconditional `record_degradation` in a loop body — every "
                    "iteration emits an event; gate it behind an episode "
                    "(flight-recorder `min_interval_s` shape) or a state-change "
                    "condition",
                )
        for child in ast.iter_child_nodes(node):
            yield from self._walk(module, child, in_loop, gated)
