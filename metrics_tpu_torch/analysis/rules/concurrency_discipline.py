"""Concurrency-discipline rules (counterpart of
``metrics_tpu/analysis/rules/concurrency_discipline.py``), GL4xx: the
thread/lock hygiene contracts
every threaded subsystem in this repo already follows by convention —
mechanized so the next one cannot quietly stop.

- ``GL401``: ``threading.Thread(...)`` without BOTH ``daemon=`` and
  ``name=``. Every thread the library spawns must be daemonized (a wedged
  worker must never block interpreter exit — the fleet/serving teardown
  contract) and named (flight-recorder dumps, witness findings, and py-spy
  output are unreadable as ``Thread-7``).
- ``GL402``: a listener/callback/hook invoked while a lock is held. The
  bug class: user code running under a library lock can re-enter the
  library (deadlock) or block it (fsync/HTTP under a hot lock).
  ``resilience/health.py`` and ``obs/flightrec.py`` both snapshot their
  listener lists and call OUTSIDE the lock — this rule pins that shape.
- ``GL403``: a lock attribute created outside ``__init__`` (or the other
  construction-path dunders). A lock born lazily in a hot method races its
  own creation: two threads each observe "no lock yet" and mint separate
  locks guarding nothing. ``Metric.__setstate__``/``__deepcopy__``
  re-minting ``_overlap_lock`` on a freshly built object is the allowed
  shape (construction paths all).
"""
import ast
from typing import Iterator, List, Optional, Set

from metrics_tpu_torch.analysis.lint import Finding, ModuleSource
from metrics_tpu_torch.analysis.rules._common import (
    dotted_parts,
    is_lockish_name,
    lock_ctor_kind,
    self_attr_assignment,
)

# the construction-path methods where minting a lock is single-threaded by
# contract: nobody else holds a reference to the object yet
_CONSTRUCTION_METHODS = frozenset(
    {"__init__", "__new__", "__setstate__", "__deepcopy__", "__copy__", "__post_init__"}
)

# callee names that mean "arbitrary user code": calling one under a held
# lock hands the lock to code the library does not control
_CALLBACK_NAME_RE_PARTS = ("listener", "listeners", "callback", "callbacks", "hook", "hooks")


def _is_callbackish(name: str) -> bool:
    low = name.lower()
    return any(low.endswith(part) for part in _CALLBACK_NAME_RE_PARTS)


class BareThread:
    rule_id = "GL401"
    name = "concurrency-bare-thread"
    description = (
        "`threading.Thread` without both `daemon=` and `name=` — unnamed/non-daemon "
        "workers block interpreter exit and are anonymous in witness/flight-recorder dumps"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            parts = dotted_parts(node.func)
            if parts is None or parts[-1] != "Thread":
                continue
            if len(parts) > 1 and parts[0] != "threading":
                continue
            kwargs = {kw.arg for kw in node.keywords}
            missing = sorted({"daemon", "name"} - kwargs)
            if missing:
                yield module.finding(
                    self.rule_id,
                    node,
                    f"thread spawned without {' and '.join(f'`{m}=`' for m in missing)} — "
                    "daemonize (teardown must never hang on a wedged worker) and name it "
                    "(witness findings and py-spy dumps key on thread names)",
                )


class CallbackUnderLock:
    rule_id = "GL402"
    name = "concurrency-callback-under-lock"
    description = (
        "listener/callback/hook invoked while a lock is held — snapshot the list under "
        "the lock, call outside it (resilience/health.py shape); user code under a "
        "library lock can re-enter (deadlock) or block it"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        yield from self._walk(module, module.tree, in_lock=False, loop_vars=set())

    def _walk(
        self, module: ModuleSource, node: ast.AST, in_lock: bool, loop_vars: Set[str]
    ) -> Iterator[Finding]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a def/lambda *body* runs later, not under the current lock
            in_lock, loop_vars = False, set()
        if isinstance(node, (ast.With, ast.AsyncWith)):
            holds = in_lock or any(
                self._lockish_context(item.context_expr) for item in node.items
            )
            for item in node.items:
                yield from self._walk(module, item.context_expr, in_lock, loop_vars)
            for stmt in node.body:
                yield from self._walk(module, stmt, holds, loop_vars)
            return
        if isinstance(node, ast.For) and in_lock:
            # `for fn in self._listeners:` — the loop var IS a callback
            extra = set(loop_vars)
            iter_parts = dotted_parts(node.iter)
            if (
                isinstance(node.target, ast.Name)
                and iter_parts is not None
                and _is_callbackish(iter_parts[-1])
            ):
                extra = extra | {node.target.id}
            yield from self._walk(module, node.iter, in_lock, loop_vars)
            for stmt in node.body + node.orelse:
                yield from self._walk(module, stmt, in_lock, extra)
            return
        if isinstance(node, ast.Call) and in_lock:
            parts = dotted_parts(node.func)
            if parts is not None and (
                _is_callbackish(parts[-1])
                or (len(parts) == 1 and parts[0] in loop_vars)
            ):
                yield module.finding(
                    self.rule_id,
                    node,
                    f"`{'.'.join(parts)}(...)` invoked under a held lock — snapshot the "
                    "callback list inside the lock and invoke OUTSIDE it (the "
                    "HealthRegistry.record shape)",
                )
        for child in ast.iter_child_nodes(node):
            yield from self._walk(module, child, in_lock, loop_vars)

    @staticmethod
    def _lockish_context(ctx: ast.AST) -> bool:
        """Does a with-item look like a lock acquisition? A lock-named
        attribute/name, or a call of a lock-provider-named method
        (``with self._state_swap_guard():``)."""
        if isinstance(ctx, ast.Call):
            parts = dotted_parts(ctx.func)
            return parts is not None and is_lockish_name(parts[-1])
        parts = dotted_parts(ctx)
        return parts is not None and is_lockish_name(parts[-1])


class LockCreatedOutsideInit:
    rule_id = "GL403"
    name = "concurrency-lazy-lock"
    description = (
        "lock attribute created outside a construction-path method — lazy lock minting "
        "races its own creation (two threads can each observe 'no lock yet'); create in "
        "__init__ (or __setstate__/__deepcopy__ on the freshly built object)"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in _CONSTRUCTION_METHODS:
                continue
            for stmt in self._own_stmts(node):
                hit = self_attr_assignment(stmt)
                if hit is not None and lock_ctor_kind(hit[1]) is not None:
                    yield module.finding(
                        self.rule_id,
                        stmt,
                        f"`self.{hit[0]}` lock created in `{node.name}()` — lazy minting "
                        "races its own creation; move to __init__ (construction-path "
                        "dunders are exempt: they run on an object no other thread holds)",
                    )

    @classmethod
    def _own_stmts(cls, fn: ast.AST) -> Iterator[ast.stmt]:
        """Statements whose nearest enclosing function is ``fn`` (nested
        defs report under their own visit, not their parent's)."""
        stack: List[ast.AST] = list(getattr(fn, "body", []))
        while stack:
            node = stack.pop()
            if isinstance(node, ast.stmt):
                yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            for child in ast.iter_child_nodes(node):
                stack.append(child)