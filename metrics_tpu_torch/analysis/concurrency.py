"""Static lock-order analysis (counterpart of
``metrics_tpu/analysis/concurrency.py``): the inter-procedural
lock-acquisition graph over ``metrics_tpu_torch/``, checked against the
port's declared hierarchy in ``metrics_tpu_torch/analysis/LOCK_ORDER.md``.

The port's locks keep the JAX package's ranks, and its own locks take the
ranks ROADMAP D64 gives them. This pass makes the ordering contract
mechanical:

1. **Lock discovery** — every ``threading.Lock()``/``RLock()``/
   ``Condition()`` creation bound to a module-level name or an instance
   attribute (plain assignment, ``object.__setattr__(self, "x", ...)``, or
   ``self.__dict__["x"] = ...``) becomes a named node
   ``<relpath>:<Class>.<attr>`` / ``<relpath>:<name>``. Creations wrapped in
   :func:`metrics_tpu_torch.analysis.lockwitness.named_lock` (how the port
   constructs every lock) are seen through.
2. **Acquisition walk** — per function, a source-order walk tracks the held
   set through ``with`` blocks (including multi-item) and linear
   ``acquire()``/``release()`` pairs. ``with self._guard():`` resolves
   through *lock providers*: methods whose body ``return``\\ s a known lock
   (the ``Metric._state_swap_guard`` idiom). Acquiring B while holding A
   records the edge A → B.
3. **Inter-procedural closure** — calls made while holding a lock (to
   same-module functions, self/class-chain methods, or symbols imported from
   other package modules) propagate the callee's transitive acquisition set
   back to the caller's held context, to a fixpoint: a method that
   *indirectly* takes a second lock three frames down shows up as a plain
   edge.

The final graph must be cycle-free AND every edge must be rank-increasing
under the manifest's declared hierarchy (or explicitly allow-listed); every
discovered lock must be declared. ``python -m metrics_tpu_torch.analysis
locks`` renders the graph and exits 1 on any violation. The runtime
witness (:mod:`metrics_tpu_torch.analysis.lockwitness`) observes the edges
this pass cannot resolve statically (callbacks, locks reached through
attributes of other objects).

Pure Python / pure AST — importing or running this module never touches
torch (same stance as :mod:`metrics_tpu_torch.analysis.lint`).
"""
import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.lint import PACKAGE_NAME, iter_package_files, package_root

__all__ = [
    "LockDef",
    "LockEdge",
    "ConcurrencyReport",
    "Violation",
    "analyze_sources",
    "analyze_package",
    "check_manifest",
    "default_manifest_path",
    "render_report",
]

# re-entrant-by-construction kinds: self-edges (acquire while already held
# by the same thread) are the designed usage, not a deadlock
_REENTRANT_KINDS = frozenset({"RLock", "Condition"})


# ---------------------------------------------------------------------------
# data model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LockDef:
    """One named lock: ``lock_id`` is ``<relpath>:<Class>.<attr>`` for
    instance locks, ``<relpath>:<name>`` for module-level ones."""

    lock_id: str
    kind: str  # "Lock" | "RLock" | "Condition"
    relpath: str
    line: int


@dataclass(frozen=True)
class LockEdge:
    """``held`` was held when ``acquired`` was taken, first observed at
    ``path:line`` (``via`` names the call chain for inter-procedural
    edges, "" for a direct nested ``with``)."""

    held: str
    acquired: str
    path: str
    line: int
    via: str = ""

    def format(self) -> str:
        how = f" (via {self.via})" if self.via else ""
        return f"{self.held} -> {self.acquired} at {self.path}:{self.line}{how}"


@dataclass(frozen=True)
class Violation:
    kind: str  # "cycle" | "undeclared-lock" | "undeclared-edge" | "order"
    message: str

    def format(self) -> str:
        return f"lock-order [{self.kind}]: {self.message}"


@dataclass
class ConcurrencyReport:
    locks: Dict[str, LockDef] = field(default_factory=dict)
    edges: Dict[Tuple[str, str], LockEdge] = field(default_factory=dict)
    cycles: List[List[str]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# pass A: per-module symbol tables
# ---------------------------------------------------------------------------


def _lock_ctor_kind(expr: ast.AST) -> Optional[str]:
    from metrics_tpu_torch.analysis.rules._common import lock_ctor_kind

    return lock_ctor_kind(expr)


def _relpath_to_dotted(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


@dataclass
class _FuncInfo:
    key: Tuple[str, Optional[str], str]  # (relpath, class name or None, fn name)
    node: ast.AST
    returns_locks: Set[str] = field(default_factory=set)
    acquires: Set[str] = field(default_factory=set)  # direct, any depth in body
    # calls made while holding: (held lock ids at the call, callee key, line)
    calls: List[Tuple[Tuple[str, ...], Tuple[str, Optional[str], str], int]] = field(
        default_factory=list
    )


@dataclass
class _ModuleInfo:
    relpath: str
    tree: ast.Module
    # local name -> lock_id (module-level locks + symbols imported from
    # other modules in the run that turn out to be locks; resolved late)
    imported_symbols: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # local alias -> relpath of another module in the run
    module_aliases: Dict[str, str] = field(default_factory=dict)
    module_locks: Dict[str, str] = field(default_factory=dict)  # name -> lock_id
    # class name -> (bases, attr name -> lock_id)
    classes: Dict[str, Tuple[List[str], Dict[str, str]]] = field(default_factory=dict)
    functions: Dict[Tuple[Optional[str], str], _FuncInfo] = field(default_factory=dict)


def _self_attr_lock_target(stmt: ast.stmt) -> Optional[Tuple[str, ast.AST]]:
    from metrics_tpu_torch.analysis.rules._common import self_attr_assignment

    return self_attr_assignment(stmt)


def _collect_module(text: str, relpath: str, dotted_index: Dict[str, str]) -> _ModuleInfo:
    tree = ast.parse(text, filename=relpath)
    info = _ModuleInfo(relpath=relpath, tree=tree)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                if alias.name in dotted_index:
                    info.module_aliases[alias.asname or alias.name] = dotted_index[alias.name]
                elif alias.asname is None and alias.name.split(".")[0] in dotted_index:
                    info.module_aliases[local] = dotted_index[alias.name.split(".")[0]]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                local = alias.asname or alias.name
                sub = f"{node.module}.{alias.name}"
                if sub in dotted_index:
                    info.module_aliases[local] = dotted_index[sub]
                elif node.module in dotted_index:
                    info.imported_symbols[local] = (dotted_index[node.module], alias.name)

    # module-level locks
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if isinstance(t, ast.Name) and _lock_ctor_kind(stmt.value):
                info.module_locks[t.id] = f"{relpath}:{t.id}"

    # classes: bases + instance lock attrs (any method may create them —
    # __setstate__/__deepcopy__ re-create; GL403 polices *where*)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = []
        for b in node.bases:
            from metrics_tpu_torch.analysis.rules._common import dotted_parts

            parts = dotted_parts(b)
            if parts is not None:
                bases.append(parts[-1])
        lock_attrs: Dict[str, str] = {}
        for sub in ast.walk(node):
            hit = _self_attr_lock_target(sub) if isinstance(sub, ast.stmt) else None
            if hit is not None and _lock_ctor_kind(hit[1]):
                lock_attrs.setdefault(hit[0], f"{relpath}:{node.name}.{hit[0]}")
        info.classes[node.name] = (bases, lock_attrs)

    # function index: module-level defs + methods (one class level deep is
    # enough for this codebase; nested defs are analyzed with their parent)
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            key = (relpath, None, stmt.name)
            info.functions[(None, stmt.name)] = _FuncInfo(key=key, node=stmt)
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    key = (relpath, stmt.name, sub.name)
                    info.functions[(stmt.name, sub.name)] = _FuncInfo(key=key, node=sub)
    return info


# ---------------------------------------------------------------------------
# pass B: per-function acquisition walk
# ---------------------------------------------------------------------------


class _Analyzer:
    def __init__(self, modules: Dict[str, _ModuleInfo]) -> None:
        self.modules = modules
        self.locks: Dict[str, LockDef] = {}
        self.edges: Dict[Tuple[str, str], LockEdge] = {}
        # package-wide class table (class names are unique in practice;
        # first definition wins on a collision)
        self.class_table: Dict[str, Tuple[str, List[str], Dict[str, str]]] = {}
        for mod in modules.values():
            for cname, (bases, lock_attrs) in mod.classes.items():
                self.class_table.setdefault(cname, (mod.relpath, bases, lock_attrs))
        self._register_locks()

    def _register_locks(self) -> None:
        for mod in self.modules.values():
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    t = stmt.targets[0]
                    kind = _lock_ctor_kind(stmt.value)
                    if isinstance(t, ast.Name) and kind:
                        lid = f"{mod.relpath}:{t.id}"
                        self.locks.setdefault(
                            lid, LockDef(lid, kind, mod.relpath, stmt.lineno)
                        )
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in ast.walk(node):
                    hit = _self_attr_lock_target(sub) if isinstance(sub, ast.stmt) else None
                    if hit is None:
                        continue
                    kind = _lock_ctor_kind(hit[1])
                    if kind:
                        lid = f"{mod.relpath}:{node.name}.{hit[0]}"
                        self.locks.setdefault(
                            lid, LockDef(lid, kind, mod.relpath, sub.lineno)
                        )

    # -- resolution ---------------------------------------------------------

    def _class_chain(self, cname: str) -> Iterable[Tuple[str, Dict[str, str]]]:
        """(defining relpath, lock attrs) walking ``cname`` then its bases
        (package classes only, loop-guarded)."""
        seen: Set[str] = set()
        queue = [cname]
        while queue:
            name = queue.pop(0)
            if name in seen or name not in self.class_table:
                continue
            seen.add(name)
            relpath, bases, lock_attrs = self.class_table[name]
            yield relpath, lock_attrs
            queue.extend(bases)

    def _chain_class_names(self, cname: str) -> Iterable[str]:
        seen: Set[str] = set()
        queue = [cname]
        while queue:
            name = queue.pop(0)
            if name in seen or name not in self.class_table:
                continue
            seen.add(name)
            yield name
            queue.extend(self.class_table[name][1])

    def resolve_lock(self, expr: ast.AST, mod: _ModuleInfo, cname: Optional[str]) -> Optional[str]:
        from metrics_tpu_torch.analysis.rules._common import dotted_parts

        parts = dotted_parts(expr)
        if parts is None:
            return None
        if len(parts) == 1:
            name = parts[0]
            if name in mod.module_locks:
                return mod.module_locks[name]
            sym = mod.imported_symbols.get(name)
            if sym is not None:
                lid = f"{sym[0]}:{sym[1]}"
                return lid if lid in self.locks else None
            return None
        if len(parts) == 2:
            owner, attr = parts
            if owner == "self" and cname is not None:
                for _, lock_attrs in self._class_chain(cname):
                    if attr in lock_attrs:
                        return lock_attrs[attr]
                return None
            target = mod.module_aliases.get(owner)
            if target is not None:
                lid = f"{target}:{attr}"
                return lid if lid in self.locks else None
        return None

    def resolve_callee(
        self, func: ast.AST, mod: _ModuleInfo, cname: Optional[str]
    ) -> Optional[_FuncInfo]:
        from metrics_tpu_torch.analysis.rules._common import dotted_parts

        parts = dotted_parts(func)
        if parts is None:
            return None
        if len(parts) == 1:
            name = parts[0]
            fi = mod.functions.get((None, name))
            if fi is not None:
                return fi
            sym = mod.imported_symbols.get(name)
            if sym is not None and sym[0] in self.modules:
                return self.modules[sym[0]].functions.get((None, sym[1]))
            return None
        if len(parts) == 2 and parts[0] == "self" and cname is not None:
            for owner in self._chain_class_names(cname):
                relpath = self.class_table[owner][0]
                fi = self.modules[relpath].functions.get((owner, parts[1]))
                if fi is not None:
                    return fi
        return None

    # -- the walk -----------------------------------------------------------

    def analyze_all(self) -> None:
        for mod in self.modules.values():
            for (cname, _), fi in mod.functions.items():
                self._walk_function(fi, mod, cname)
        self._close_interprocedural()

    def _note_acquire(
        self, lock_id: str, held: List[str], mod: _ModuleInfo, line: int, via: str = ""
    ) -> None:
        kind = self.locks[lock_id].kind
        for h in held:
            if h == lock_id:
                if kind in _REENTRANT_KINDS:
                    continue  # designed re-entrancy
            self.edges.setdefault(
                (h, lock_id), LockEdge(h, lock_id, mod.relpath, line, via)
            )

    def _walk_function(self, fi: _FuncInfo, mod: _ModuleInfo, cname: Optional[str]) -> None:
        body = getattr(fi.node, "body", [])
        self._walk_stmts(body, [], fi, mod, cname)

    def _walk_stmts(
        self,
        stmts: Sequence[ast.stmt],
        held: List[str],
        fi: _FuncInfo,
        mod: _ModuleInfo,
        cname: Optional[str],
    ) -> None:
        # `held` is mutated by linear acquire()/release() for the remainder
        # of THIS statement list; with-blocks get a scoped copy
        for stmt in stmts:
            # lock-provider detection: `return self._overlap_lock`
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                lid = self.resolve_lock(stmt.value, mod, cname)
                if lid is not None:
                    fi.returns_locks.add(lid)
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in stmt.items:
                    acquired = self._with_item_locks(item.context_expr, fi, mod, cname)
                    for lid in acquired:
                        self._note_acquire(lid, inner, mod, stmt.lineno)
                        fi.acquires.add(lid)
                        inner.append(lid)
                    if not acquired:
                        # unknown context manager: still scan its expression
                        # for calls made while holding
                        self._scan_expr(item.context_expr, inner, fi, mod, cname)
                self._walk_stmts(stmt.body, inner, fi, mod, cname)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: the body runs later, not under the current
                # held set — analyze with an empty context
                self._walk_stmts(stmt.body, [], fi, mod, cname)
                continue
            # generic statement: scan expressions for acquire/release/calls,
            # then recurse into compound bodies with the (possibly grown) set
            for expr in self._stmt_exprs(stmt):
                self._scan_expr(expr, held, fi, mod, cname)
            for sub_body in self._stmt_bodies(stmt):
                self._walk_stmts(sub_body, held, fi, mod, cname)

    @staticmethod
    def _stmt_exprs(stmt: ast.stmt) -> List[ast.AST]:
        """Expression children of ``stmt`` that are NOT nested statement
        bodies (those recurse separately, preserving source order)."""
        out: List[ast.AST] = []
        for name, value in ast.iter_fields(stmt):
            if name in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.AST):
                out.append(value)
            elif isinstance(value, list):
                out.extend(v for v in value if isinstance(v, ast.expr))
        return out

    @staticmethod
    def _stmt_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
        out: List[List[ast.stmt]] = []
        for attr in ("body", "orelse", "finalbody"):
            body = getattr(stmt, attr, None)
            if body:
                out.append(body)
        for handler in getattr(stmt, "handlers", []) or []:
            out.append(handler.body)
        return out

    def _with_item_locks(
        self, ctx: ast.AST, fi: _FuncInfo, mod: _ModuleInfo, cname: Optional[str]
    ) -> List[str]:
        """Lock ids a with-item acquires: a lock expression, a provider
        call (``with self._state_swap_guard():``), or ``lock.acquire()``
        misuse inside with (rare; treated as the lock)."""
        lid = self.resolve_lock(ctx, mod, cname)
        if lid is not None:
            return [lid]
        if isinstance(ctx, ast.Call):
            callee = self.resolve_callee(ctx.func, mod, cname)
            if callee is not None:
                # providers are cheap to resolve eagerly: their returns are
                # direct lock expressions, found on the callee's own walk —
                # which may not have run yet, so compute on demand
                if not callee.returns_locks:
                    self._prescan_returns(callee)
                if callee.returns_locks:
                    return sorted(callee.returns_locks)
        return []

    def _prescan_returns(self, fi: _FuncInfo) -> None:
        relpath, cname, _ = fi.key
        mod = self.modules[relpath]
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Return) and node.value is not None:
                lid = self.resolve_lock(node.value, mod, cname)
                if lid is not None:
                    fi.returns_locks.add(lid)

    def _scan_expr(
        self,
        expr: ast.AST,
        held: List[str],
        fi: _FuncInfo,
        mod: _ModuleInfo,
        cname: Optional[str],
    ) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda,)):
                continue  # body runs later
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in ("acquire", "release"):
                lid = self.resolve_lock(func.value, mod, cname)
                if lid is not None:
                    if func.attr == "acquire":
                        self._note_acquire(lid, held, mod, node.lineno)
                        fi.acquires.add(lid)
                        held.append(lid)
                    elif lid in held:
                        held.remove(lid)
                    continue
            callee = self.resolve_callee(func, mod, cname)
            if callee is not None and held:
                fi.calls.append((tuple(held), callee.key, node.lineno))

    # -- inter-procedural closure ------------------------------------------

    def _close_interprocedural(self) -> None:
        index: Dict[Tuple[str, Optional[str], str], _FuncInfo] = {}
        for mod in self.modules.values():
            for fi in mod.functions.values():
                index[fi.key] = fi
        # transitive acquisition sets, to a fixpoint
        trans: Dict[Tuple[str, Optional[str], str], Set[str]] = {
            key: set(fi.acquires) for key, fi in index.items()
        }
        changed = True
        while changed:
            changed = False
            for key, fi in index.items():
                acc = trans[key]
                before = len(acc)
                for _, callee_key, _ in fi.calls:
                    acc |= trans.get(callee_key, set())
                if len(acc) != before:
                    changed = True
        for fi in index.values():
            relpath = fi.key[0]
            mod = self.modules[relpath]
            for held, callee_key, line in fi.calls:
                callee_name = callee_key[2]
                for lock_id in sorted(trans.get(callee_key, ())):
                    self._note_acquire(
                        lock_id, list(held), mod, line, via=f"{callee_name}()"
                    )

    # -- cycles -------------------------------------------------------------

    def find_cycles(self) -> List[List[str]]:
        graph: Dict[str, Set[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        cycles: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        # simple DFS cycle enumeration (graphs here have ~a dozen nodes)
        for start in sorted(graph):
            stack: List[Tuple[str, List[str]]] = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(graph.get(node, ())):
                    if nxt == start:
                        # canonicalize rotation so each cycle reports once
                        rot = min(range(len(path)), key=lambda i: path[i])
                        canon = tuple(path[rot:] + path[:rot])
                        if canon not in seen_cycles:
                            seen_cycles.add(canon)
                            cycles.append(list(canon) + [canon[0]])
                    elif nxt not in path and nxt > start:
                        stack.append((nxt, path + [nxt]))
        return cycles


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def analyze_sources(named_sources: Sequence[Tuple[str, str]]) -> ConcurrencyReport:
    """Analyze ``[(text, relpath), ...]`` (the fixture-test entry point)."""
    dotted_index = {_relpath_to_dotted(rel): rel for _, rel in named_sources}
    modules = {
        rel: _collect_module(text, rel, dotted_index) for text, rel in named_sources
    }
    an = _Analyzer(modules)
    an.analyze_all()
    return ConcurrencyReport(locks=an.locks, edges=an.edges, cycles=an.find_cycles())


def analyze_package(package_dir: Optional[str] = None) -> ConcurrencyReport:
    """Analyze every module of ``metrics_tpu_torch/`` (default) or
    ``package_dir``, lock ids relative to the repo root."""
    root = package_root()
    if package_dir is None:
        package_dir = os.path.join(root, PACKAGE_NAME)
    named: List[Tuple[str, str]] = []
    for path in iter_package_files(package_dir):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as fh:
            named.append((fh.read(), relpath))
    return analyze_sources(named)


# ---------------------------------------------------------------------------
# manifest (analysis/LOCK_ORDER.md)
# ---------------------------------------------------------------------------

MANIFEST_FILENAME = "LOCK_ORDER.md"
_RANK_RE = re.compile(r"^\s*-\s*rank\s+(\d+)\s*:\s*(\S+)")
_ALLOW_RE = re.compile(r"^\s*-\s*allow\s*:\s*(\S+)\s*->\s*(\S+)")


def default_manifest_path() -> str:
    """The port's manifest, beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), MANIFEST_FILENAME)


def parse_manifest(text: str) -> Tuple[Dict[str, int], Set[Tuple[str, str]]]:
    """(lock_id -> rank, allowed extra edges). Lines matching
    ``- rank N: <lock-id>`` and ``- allow: <a> -> <b>``; all other lines
    are prose."""
    ranks: Dict[str, int] = {}
    allowed: Set[Tuple[str, str]] = set()
    for line in text.splitlines():
        m = _RANK_RE.match(line)
        if m:
            ranks[m.group(2)] = int(m.group(1))
            continue
        m = _ALLOW_RE.match(line)
        if m:
            allowed.add((m.group(1), m.group(2)))
    return ranks, allowed


def check_manifest(report: ConcurrencyReport, manifest_text: str) -> List[Violation]:
    """Violations of the declared hierarchy: cycles always fail; every
    discovered lock must carry a rank; every edge must be strictly
    rank-increasing or explicitly ``allow``-listed."""
    ranks, allowed = parse_manifest(manifest_text)
    out: List[Violation] = []
    for cyc in report.cycles:
        out.append(
            Violation(
                "cycle",
                "potential deadlock: " + " -> ".join(cyc),
            )
        )
    for lock_id in sorted(report.locks):
        if lock_id not in ranks:
            out.append(
                Violation(
                    "undeclared-lock",
                    f"{lock_id} has no rank in {MANIFEST_FILENAME} — every named "
                    "lock must be placed in the hierarchy when introduced",
                )
            )
    for (a, b), edge in sorted(report.edges.items()):
        if a == b:
            continue  # reported via cycles (non-reentrant) or designed (RLock)
        if (a, b) in allowed:
            continue
        ra, rb = ranks.get(a), ranks.get(b)
        if ra is None or rb is None:
            out.append(
                Violation(
                    "undeclared-edge",
                    f"{edge.format()} — endpoint missing from the manifest",
                )
            )
        elif ra >= rb:
            out.append(
                Violation(
                    "order",
                    f"{edge.format()} violates the declared hierarchy "
                    f"(rank {ra} -> rank {rb}; inner locks must rank strictly "
                    f"higher, or add an explicit `- allow:` entry with rationale)",
                )
            )
    # stale manifest entries: declared locks that no longer exist
    for lock_id in sorted(ranks):
        if lock_id not in report.locks:
            out.append(
                Violation(
                    "undeclared-lock",
                    f"{lock_id} is ranked in {MANIFEST_FILENAME} but no longer "
                    "exists in the tree — prune the manifest",
                )
            )
    return out


def render_report(report: ConcurrencyReport, violations: Sequence[Violation]) -> str:
    lines: List[str] = []
    lines.append(f"lock-order: {len(report.locks)} named lock(s), {len(report.edges)} edge(s)")
    for lock_id in sorted(report.locks):
        d = report.locks[lock_id]
        lines.append(f"  lock {lock_id} [{d.kind}] ({d.relpath}:{d.line})")
    for key in sorted(report.edges):
        lines.append(f"  edge {report.edges[key].format()}")
    for v in violations:
        lines.append(v.format())
    lines.append(
        f"lock-order: {len(violations)} violation(s) "
        f"({len(report.cycles)} cycle(s)) against {MANIFEST_FILENAME}"
    )
    return "\n".join(lines)
