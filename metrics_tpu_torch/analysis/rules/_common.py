"""Helpers shared across graft-lint rules (counterpart of
``metrics_tpu/analysis/rules/_common.py``): one definition per AST pattern,
so the rule families cannot drift apart on what counts as a host-side class
or a declared state, and the concurrency family cannot drift from
:mod:`metrics_tpu_torch.analysis.concurrency` on what counts as a lock
creation.

The JAX package's Pallas-callee helpers (``_pallas_callee_of``,
``pallas_callee_names``, ``module_level_pallas_callee_names``) served only
its trace-safety rules, which are not ported (ROADMAP D69): the port has no
``pl.pallas_call``, so they are left out.
"""
import ast
import re
from typing import List, Optional, Set, Tuple

LOCK_CTORS = frozenset({"Lock", "RLock", "Condition"})

# names the concurrency-discipline heuristics treat as lock-like when no
# definition is resolvable: `_lock`, `_cv`, `_cond`, `_guard` suffixes plus
# the bare spellings
LOCKISH_NAME_RE = re.compile(r"(^|_)(lock|locks|cv|cond|condition|guard)$")


def is_lockish_name(name: str) -> bool:
    return bool(LOCKISH_NAME_RE.search(name))


def lock_ctor_kind(expr: ast.AST) -> Optional[str]:
    """The lock kind a creation expression yields, seeing through wrapper
    calls (``named_lock("x", threading.Lock())``): the FIRST
    ``threading.Lock/RLock/Condition`` call anywhere in the expression
    (bare names count only for the from-import spelling)."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        parts = dotted_parts(node.func)
        if parts is None or parts[-1] not in LOCK_CTORS:
            continue
        if len(parts) == 1 or parts[0] == "threading":
            return parts[-1]
    return None


def self_attr_assignment(stmt: ast.stmt) -> Optional[Tuple[str, ast.AST]]:
    """(attr name, value expr) when ``stmt`` binds an instance attribute by
    any of the package's three spellings: ``self.x = v``,
    ``object.__setattr__(self_or_obj, "x", v)`` (the frozen-dataclass
    idiom), or ``self.__dict__["x"] = v``."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
        t = stmt.targets[0]
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        ):
            return t.attr, stmt.value
        if (
            isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Attribute)
            and t.value.attr == "__dict__"
            and isinstance(t.value.value, ast.Name)
            and t.value.value.id == "self"
            and isinstance(t.slice, ast.Constant)
            and isinstance(t.slice.value, str)
        ):
            return t.slice.value, stmt.value
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        call = stmt.value
        parts = dotted_parts(call.func)
        if (
            parts is not None
            and parts[-1] == "__setattr__"
            and len(call.args) == 3
            and isinstance(call.args[1], ast.Constant)
            and isinstance(call.args[1].value, str)
        ):
            return call.args[1].value, call.args[2]
    return None


def dotted_parts(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a", "b", "c"); None for non-Name-rooted expressions.
    The one attribute-chain walker every rule family shares."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def class_opts_out_of_jit(node: ast.ClassDef) -> bool:
    """True when the class body sets ``jittable_update = False`` (the
    repo's host-side opt-out, ``metric.py``) — via plain or annotated
    assignment."""
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
            value = stmt.value
        else:
            continue
        if (
            any(isinstance(t, ast.Name) and t.id == "jittable_update" for t in targets)
            and isinstance(value, ast.Constant)
            and value.value is False
        ):
            return True
    return False


def declared_state_names(root: ast.AST) -> Set[str]:
    """State leaves declared via ``self.add_state("name", ...)`` anywhere
    under ``root`` (a ClassDef or a whole Module; literal first arg or
    ``name=`` kwarg). Attribute reads of these names on ``self`` resolve to
    metric STATE — traced arrays inside compiled updates — not
    python-scalar config. The lint engine unions these across every module
    in a run (``ModuleSource.package_state_names``) because states are
    routinely declared in a base class in another module."""
    names: Set[str] = set()
    for node in ast.walk(root):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_state"
        ):
            continue
        arg = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "name":
                arg = kw.value
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            names.add(arg.value)
    return names
