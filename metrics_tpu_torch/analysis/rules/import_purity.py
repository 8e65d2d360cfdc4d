"""Import-purity rules (counterpart of
``metrics_tpu/analysis/rules/import_purity.py``): ``import
metrics_tpu_torch`` never touches CUDA.

The port's contract (ROADMAP, "What this machine can run"): importing any
module builds no kernel, loads no library and initialises no CUDA context,
so the package imports on a machine without a card and a wedged card
cannot hang an import. The first call on a CUDA tensor builds and loads.
These rules make that contract mechanical:

- ``GL101``: module-scope call to a CUDA discovery function
  (``torch.cuda.is_available``, ``device_count``, ``get_device_name``,
  ``current_device``, ``init`` and the other calls that initialise CUDA).
- ``GL102``: module-scope call that makes a CUDA tensor (a ``device=``
  argument naming ``"cuda"``, ``.cuda()``, ``.to("cuda")``) or that builds
  or loads a kernel (``ops/_build.py::build``/``load``).

"Module scope" is everything that executes at import: top-level
statements, class bodies, decorator expressions, and function-argument
defaults — but not function bodies, and not ``if __name__ == "__main__"``
blocks. A bare reference (``DEVICE = torch.device("cuda")``, which opens
nothing) is fine; only the calls above are flagged.
"""
import ast
from typing import Iterator, List, Optional, Set, Tuple

from metrics_tpu_torch.analysis.lint import Finding, ModuleSource
from metrics_tpu_torch.analysis.rules._common import dotted_parts as _dotted

# torch.cuda functions whose call initialises CUDA (device discovery or
# context creation)
DISCOVERY_FUNCS = frozenset(
    {
        "is_available",
        "device_count",
        "get_device_name",
        "get_device_properties",
        "get_device_capability",
        "current_device",
        "set_device",
        "synchronize",
        "init",
    }
)
# the kernel build and load entry points (metrics_tpu_torch/ops/_build.py)
KERNEL_FUNCS = frozenset({"build", "load"})
_BUILD_MODULE = "metrics_tpu_torch.ops._build"


class ImportAliases:
    """Names bound to ``torch``, ``torch.cuda`` and the kernel build module by
    this module's imports."""

    def __init__(self, tree: ast.Module) -> None:
        self.torch: Set[str] = set()
        self.cuda: Set[str] = set()  # import torch.cuda as tc / from torch import cuda
        self.discovery_members: Set[str] = set()  # from torch.cuda import is_available
        self.build_modules: Set[str] = set()  # from metrics_tpu_torch.ops import _build
        self.kernel_members: Set[str] = set()  # from metrics_tpu_torch.ops._build import build
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "torch" or (alias.name.startswith("torch.") and alias.asname is None):
                        self.torch.add("torch")
                    if alias.name == "torch" and alias.asname:
                        self.torch.add(alias.asname)
                    elif alias.name == "torch.cuda" and alias.asname:
                        self.cuda.add(alias.asname)
                    elif alias.name == _BUILD_MODULE and alias.asname:
                        self.build_modules.add(alias.asname)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if node.module == "torch" and alias.name == "cuda":
                        self.cuda.add(bound)
                    elif node.module == "torch.cuda" and alias.name in DISCOVERY_FUNCS:
                        self.discovery_members.add(bound)
                    elif node.module == "metrics_tpu_torch.ops" and alias.name == "_build":
                        self.build_modules.add(bound)
                    elif node.module == _BUILD_MODULE and alias.name in KERNEL_FUNCS:
                        self.kernel_members.add(bound)

    def classify_call(self, call: ast.Call) -> Optional[str]:
        """'discovery' | 'cuda' | None for a module-scope call."""
        dotted = _dotted(call.func)
        if dotted is not None:
            root, rest = dotted[0], dotted[1:]
            if not rest:
                if root in self.discovery_members:
                    return "discovery"
                if root in self.kernel_members:
                    return "cuda"
            elif root in self.torch and rest[0] == "cuda" and len(rest) == 2 and rest[1] in DISCOVERY_FUNCS:
                return "discovery"
            elif root in self.cuda and len(rest) == 1 and rest[0] in DISCOVERY_FUNCS:
                return "discovery"
            elif root in self.build_modules and len(rest) == 1 and rest[0] in KERNEL_FUNCS:
                return "cuda"
        if isinstance(call.func, ast.Attribute):
            if call.func.attr == "cuda":  # x.cuda(...)
                return "cuda"
            if call.func.attr == "to" and any(_names_cuda(a) for a in list(call.args) + [k.value for k in call.keywords]):
                return "cuda"
        if any(k.arg == "device" and _names_cuda(k.value) for k in call.keywords):
            return "cuda"
        return None


def _names_cuda(node: ast.AST) -> bool:
    """A literal device that is CUDA: ``"cuda"``, ``"cuda:0"``, or
    ``torch.device("cuda"...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cuda"
    if isinstance(node, ast.Call):
        parts = _dotted(node.func)
        if parts is not None and parts[-1] == "device" and node.args:
            return _names_cuda(node.args[0])
    return False


def _main_guard_kind(node: ast.If) -> Optional[str]:
    """'eq' for ``if __name__ == "__main__"`` (body skipped at import),
    'ne' for ``if __name__ != "__main__"`` (body RUNS at import, else
    skipped), None for anything else."""
    t = node.test
    if not (
        isinstance(t, ast.Compare)
        and isinstance(t.left, ast.Name)
        and t.left.id == "__name__"
        and len(t.ops) == 1
        and len(t.comparators) == 1
        and isinstance(t.comparators[0], ast.Constant)
        and t.comparators[0].value == "__main__"
    ):
        return None
    if isinstance(t.ops[0], ast.Eq):
        return "eq"
    if isinstance(t.ops[0], ast.NotEq):
        return "ne"
    return None


def iter_import_scope_calls(tree: ast.Module) -> Iterator[ast.Call]:
    """Every Call node that executes at import time.

    Recurses through module-level compound statements and class bodies;
    function/lambda *bodies* are skipped but their decorators and argument
    defaults (which evaluate at import) are walked.
    """

    def walk_stmts(stmts) -> Iterator[ast.Call]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in stmt.decorator_list:
                    yield from _calls_in_expr(dec)
                for default in list(stmt.args.defaults) + [d for d in stmt.args.kw_defaults if d is not None]:
                    yield from _calls_in_expr(default)
                continue
            if isinstance(stmt, ast.ClassDef):
                for dec in stmt.decorator_list:
                    yield from _calls_in_expr(dec)
                for base in stmt.bases + [kw.value for kw in stmt.keywords]:
                    yield from _calls_in_expr(base)
                yield from walk_stmts(stmt.body)
                continue
            if isinstance(stmt, ast.If):
                guard = _main_guard_kind(stmt)
                if guard == "eq":
                    yield from walk_stmts(stmt.orelse)
                    continue
                if guard == "ne":
                    yield from walk_stmts(stmt.body)
                    continue
                yield from _calls_in_expr(stmt.test)
                yield from walk_stmts(stmt.body)
                yield from walk_stmts(stmt.orelse)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                yield from _calls_in_expr(stmt.iter)
                yield from walk_stmts(stmt.body)
                yield from walk_stmts(stmt.orelse)
                continue
            if isinstance(stmt, ast.While):
                yield from _calls_in_expr(stmt.test)
                yield from walk_stmts(stmt.body)
                yield from walk_stmts(stmt.orelse)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    yield from _calls_in_expr(item.context_expr)
                yield from walk_stmts(stmt.body)
                continue
            if isinstance(stmt, ast.Try):
                yield from walk_stmts(stmt.body)
                for handler in stmt.handlers:
                    yield from walk_stmts(handler.body)
                yield from walk_stmts(stmt.orelse)
                yield from walk_stmts(stmt.finalbody)
                continue
            yield from _calls_in_expr(stmt)

    def _calls_in_expr(node: ast.AST) -> Iterator[ast.Call]:
        # lambda/function/class BODIES don't execute at import — prune them;
        # defs nested in statements walk_stmts has no case for (a `match`)
        # still evaluate their decorators, defaults and class bodies
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield from walk_stmts([node])
            return
        if isinstance(node, ast.Call):
            yield node
        for child in ast.iter_child_nodes(node):
            yield from _calls_in_expr(child)

    yield from walk_stmts(tree.body)


def _classified_import_scope_calls(module: ModuleSource) -> List[Tuple[ast.Call, Optional[str]]]:
    """(call, 'discovery'|'cuda'|None) for every import-scope call —
    computed once per module and shared by GL101/GL102."""
    cached = module.cache.get("import_scope_calls")
    if cached is None:
        aliases = ImportAliases(module.tree)
        cached = [(call, aliases.classify_call(call)) for call in iter_import_scope_calls(module.tree)]
        module.cache["import_scope_calls"] = cached
    return cached


def _call_text(call: ast.Call) -> str:
    dotted = _dotted(call.func)
    if dotted is not None:
        return ".".join(dotted)
    return f"<expr>.{call.func.attr}" if isinstance(call.func, ast.Attribute) else "<call>"


class DeviceDiscoveryAtImport:
    rule_id = "GL101"
    name = "import-purity-device-discovery"
    description = (
        "module-scope call to a CUDA discovery function; `import metrics_tpu_torch` "
        "must never initialise CUDA (the import contract, utilities/backend.py)"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        for call, kind in _classified_import_scope_calls(module):
            if kind == "discovery":
                yield module.finding(
                    self.rule_id,
                    call,
                    f"module-scope `{_call_text(call)}()` initialises CUDA at import — "
                    "while the card is wedged this hangs `import metrics_tpu_torch`; move the "
                    "call inside a function (see utilities/backend.py)",
                )


class CudaWorkAtImport:
    rule_id = "GL102"
    name = "import-purity-cuda-work"
    description = (
        "module-scope call makes a CUDA tensor or builds/loads a kernel, initializing "
        "CUDA at import (kernels build at their first call on a CUDA tensor)"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        for call, kind in _classified_import_scope_calls(module):
            if kind == "cuda":
                yield module.finding(
                    self.rule_id,
                    call,
                    f"module-scope `{_call_text(call)}(...)` makes a CUDA tensor or builds/loads "
                    "a kernel at import — construct it lazily inside a function (a bare "
                    "`torch.device(\"cuda\")` without a tensor is fine)",
                )
