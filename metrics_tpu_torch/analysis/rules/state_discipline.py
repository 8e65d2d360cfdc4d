"""State-discipline rules (counterpart of
``metrics_tpu/analysis/rules/state_discipline.py``): metric state goes
through ``add_state``, and list ('cat') states declare their dtype/shape
template.

``add_state`` is the single choke point where reductions, persistence,
defaults, and sync templates are registered (``metric.py``). A direct
``self._state[...] = ...`` write bypasses every one of those registrations:
the leaf won't sync, won't snapshot, and won't reset. Likewise a list state
registered without ``template=`` gathers as the legacy float32 ``(0,)`` on
an empty rank, silently corrupting dtype/trailing-shape of the synced
result (the ``template=`` contract, ``parallel/sync.py``).

- ``GL301``: subscript or attribute assignment to ``._state`` /
  ``._defaults`` anywhere outside the Metric base module itself.
- ``GL302``: ``self.add_state(..., default=[] , ...)`` without a
  ``template`` kwarg. An EXPLICIT ``template=None`` passes: it declares at
  the call site that the state's rows are ragged (data-dependent trailing
  shape — image batches, per-image detection arrays) and no static template
  exists. Classes whose body sets ``jittable_update = False`` (host-side
  metrics whose list states hold non-array payloads, e.g. the text family's
  token lists) are skipped entirely.
"""
import ast
from typing import Iterator, Optional, Set

from metrics_tpu_torch.analysis.lint import Finding, ModuleSource

# the one module allowed to touch the underscore state machinery directly
_STATE_OWNER_MODULES = ("metrics_tpu_torch/metric.py",)
_STATE_ATTRS = frozenset({"_state", "_defaults"})


class DirectStateWrite:
    rule_id = "GL301"
    name = "state-discipline-direct-write"
    description = (
        "direct `_state`/`_defaults` assignment bypasses add_state's reduction/"
        "persistence/template registration — the leaf won't sync, snapshot, or reset"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        if module.relpath in _STATE_OWNER_MODULES:
            return
        for node in ast.walk(module.tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            # unpacking assignments hide state writes inside (possibly
            # nested) Tuple/List/Starred targets: `m._state["x"], y = v, 1`
            def flatten(t):
                if isinstance(t, (ast.Tuple, ast.List)):
                    for elt in t.elts:
                        yield from flatten(elt)
                elif isinstance(t, ast.Starred):
                    yield from flatten(t.value)
                else:
                    yield t
            for target in [f for t in targets for f in flatten(t)]:
                hit = self._state_write(target)
                if hit is not None:
                    yield module.finding(
                        self.rule_id,
                        node,
                        f"direct write to `{hit}` — declare metric state via "
                        "`self.add_state(name, default, dist_reduce_fx=...)` so the "
                        "reduction, persistence, and sync template are registered",
                    )

    @staticmethod
    def _state_write(target: ast.AST) -> Optional[str]:
        # matches `<obj>._state[...] = ...` at any subscript depth
        # (`_state["x"][0] = ...` is an in-place row write that equally
        # bypasses add_state), `<obj>._state = ...`, and the `_defaults`
        # twins
        node = target
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and node.attr in _STATE_ATTRS:
            prefix = "..." if not isinstance(node.value, ast.Name) else node.value.id
            suffix = "[...]" if isinstance(target, ast.Subscript) else ""
            return f"{prefix}.{node.attr}{suffix}"
        return None


def _unjittable_update_classes(tree: ast.Module) -> Set[str]:
    from metrics_tpu_torch.analysis.rules._common import class_opts_out_of_jit

    return {
        node.name
        for node in ast.walk(tree)
        if isinstance(node, ast.ClassDef) and class_opts_out_of_jit(node)
    }


class ListStateWithoutTemplate:
    rule_id = "GL302"
    name = "state-discipline-list-template"
    description = (
        "list ('cat') state declared without `template=` — an empty rank gathers as "
        "float32 (0,) instead of the declared dtype/trailing shape (parallel/sync.py)"
    )

    def check(self, module: ModuleSource) -> Iterator[Finding]:
        skip_classes = _unjittable_update_classes(module.tree)

        class_stack: list = []

        def walk(node: ast.AST) -> Iterator[Finding]:
            if isinstance(node, ast.ClassDef):
                class_stack.append(node.name)
                for child in ast.iter_child_nodes(node):
                    yield from walk(child)
                class_stack.pop()
                return
            if isinstance(node, ast.Call) and self._is_add_state(node):
                in_host_side_class = any(c in skip_classes for c in class_stack)
                finding = self._check_call(module, node)
                if finding is not None and not in_host_side_class:
                    yield finding
            for child in ast.iter_child_nodes(node):
                yield from walk(child)

        yield from walk(module.tree)

    @staticmethod
    def _is_add_state(call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "add_state":
            return True
        return isinstance(func, ast.Name) and func.id == "add_state"

    def _check_call(self, module: ModuleSource, call: ast.Call) -> Optional[Finding]:
        default: Optional[ast.AST] = None
        if len(call.args) >= 2:
            default = call.args[1]
        for kw in call.keywords:
            if kw.arg == "default":
                default = kw.value
            if kw.arg == "template":
                return None  # declared — nothing to flag
        if isinstance(default, ast.List):
            return module.finding(
                self.rule_id,
                call,
                "list ('cat') state without `template=`: pass an empty `(0, *row)` array "
                "of the state's dtype so empty-rank gathers keep the declared shape, or "
                "an explicit `template=None` to declare the rows ragged "
                "(add_state's `template=` kwarg, metric.py)",
            )
        return None
