"""The AST lint engine (counterpart of ``metrics_tpu/analysis/lint.py``):
walks the port's source, runs the registered rules, and applies per-line
suppressions.

Pure Python / pure AST: importing or running this module never touches
torch or CUDA, so the lint pass runs on a machine without a card (the
contract the import-purity rules keep).

Suppression syntax (trailing comment on the offending line)::

    HALF = torch.ones(1, device="cuda")  # graft-lint: disable=GL102
    x = os.environ.get("X")              # graft-lint: disable=GL501,GL502
    y = risky()                          # graft-lint: disable=all

    # graft-lint: disable=GL301 — with the justification spelled out in a
    # comment block directly above the offending statement
    obj._state[name] = value

Suppressions are scoped to the finding's *reported* line (the node's first
line for multi-line statements): the trailing comment on that line, or a
contiguous comment block immediately above it. Grandfathered findings that
predate the linter live in the checked-in baseline file instead
(:mod:`metrics_tpu_torch.analysis.baseline`).
"""
import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

# capture id tokens only — anything after the id list (a space-separated
# justification, an em-dash, prose) must not leak into the ids
SUPPRESS_RE = re.compile(
    r"#\s*graft-lint\s*:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


@dataclass(frozen=True)
class Finding:
    """One lint finding. ``snippet`` (the stripped source line) is what the
    baseline fingerprints on, so findings survive unrelated line shifts."""

    rule_id: str
    path: str  # repo-relative posix path
    line: int  # 1-based
    col: int  # 0-based
    message: str
    snippet: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}"


class ModuleSource:
    """One parsed module handed to every rule: path, raw lines, AST.

    ``package_state_names`` is the cross-file union of ``add_state("name")``
    literals over every module in the lint run. Metric states are routinely
    declared in a base class in ANOTHER module (Accuracy's ``tp`` lives in
    StatScores), so a per-class or per-module view would exempt
    ``float(self.tp)`` in the subclass — the union is inheritance-proof
    without needing cross-module class resolution. For single-module
    ``lint_source`` runs it degrades to the module's own declarations.
    """

    def __init__(
        self,
        text: str,
        relpath: str,
        path: Optional[str] = None,
        package_state_names: Optional[Set[str]] = None,
    ) -> None:
        self.text = text
        self.relpath = relpath.replace(os.sep, "/")
        self.path = path or relpath
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        if package_state_names is None:
            from metrics_tpu_torch.analysis.rules._common import declared_state_names

            package_state_names = declared_state_names(self.tree)
        self.package_state_names = package_state_names
        # scratch space for rules: derived whole-module analyses (function
        # index, import aliases, scope walks) are computed by the first rule
        # of a family and reused by its siblings instead of re-walking the
        # AST once per rule
        self.cache: Dict[str, object] = {}

    def source_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule_id=rule_id,
            path=self.relpath,
            line=line,
            col=col,
            message=message,
            snippet=self.source_line(line).strip(),
        )

    def suppressed_ids(self, line: int) -> Set[str]:
        """Rule ids suppressed at ``line``: its trailing comment plus any
        contiguous pure-comment block immediately above."""
        ids = self._ids_on_line(line)
        probe = line - 1
        while probe >= 1 and self.source_line(probe).lstrip().startswith("#"):
            ids |= self._ids_on_line(probe)
            probe -= 1
        return ids

    def _comment_on_line(self, line: int) -> str:
        """The actual COMMENT token on ``line`` (tokenized once per module),
        so a ``graft-lint: disable=`` marker inside a string literal cannot
        suppress findings."""
        comments = self.cache.get("comment_tokens")
        if comments is None:
            import io
            import tokenize

            comments = {}
            try:
                for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
                    if tok.type == tokenize.COMMENT:
                        comments[tok.start[0]] = tok.string
            except (tokenize.TokenError, IndentationError):  # pragma: no cover
                pass  # partial map is fine: unreached lines just have no comment
            self.cache["comment_tokens"] = comments
        return comments.get(line, "")

    def _ids_on_line(self, line: int) -> Set[str]:
        m = SUPPRESS_RE.search(self._comment_on_line(line))
        if not m:
            return set()
        return {tok.strip() for tok in m.group(1).split(",") if tok.strip()}


def _is_suppressed(finding: Finding, module: ModuleSource) -> bool:
    ids = module.suppressed_ids(finding.line)
    return "all" in ids or finding.rule_id in ids


def _run_rules(module: ModuleSource, rules: Optional[Sequence]) -> List[Finding]:
    from metrics_tpu_torch.analysis.rules import ALL_RULES

    findings: List[Finding] = []
    for rule in rules if rules is not None else ALL_RULES:
        for f in rule.check(module):
            if not _is_suppressed(f, module):
                findings.append(f)
    return findings


def lint_source(
    text: str, relpath: str = "<string>", rules: Optional[Sequence] = None
) -> List[Finding]:
    """Lint one module given as source text (the fixture-test entry point)."""
    findings = _run_rules(ModuleSource(text, relpath), rules)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return findings


def iter_package_files(package_dir: str) -> Iterable[str]:
    """Yield every ``.py`` file under ``package_dir`` (sorted, no caches)."""
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def lint_paths(
    paths: Iterable[str], root: str, rules: Optional[Sequence] = None
) -> List[Finding]:
    """Lint files, reporting paths relative to ``root``. Files that fail to
    parse surface as a ``GL000`` finding instead of crashing the run — a
    syntax error is itself a finding, and one broken file must not hide the
    rest of the package.

    Two-phase: every module parses first so the cross-file
    ``package_state_names`` union exists before any rule runs (a state
    declared in a base class in module A must not be exempt as "config"
    when read via ``self`` in module B).
    """
    findings: List[Finding] = []
    modules: List[ModuleSource] = []
    for path in paths:
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
        try:
            modules.append(ModuleSource(text, relpath=relpath, path=path))
        except SyntaxError as err:
            findings.append(
                Finding(
                    rule_id="GL000",
                    path=relpath,
                    line=err.lineno or 1,
                    col=(err.offset or 1) - 1,
                    message=f"syntax error: {err.msg}",
                    snippet=(err.text or "").strip(),
                )
            )
    package_state_names = set()
    for module in modules:
        package_state_names |= module.package_state_names
    for module in modules:
        module.package_state_names = package_state_names
        findings.extend(_run_rules(module, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return findings


PACKAGE_NAME = "metrics_tpu_torch"


def package_root() -> str:
    """Directory containing the ``metrics_tpu_torch`` package (the repo
    root): findings report paths relative to it."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def lint_package(
    package_dir: Optional[str] = None, rules: Optional[Sequence] = None
) -> List[Finding]:
    """Lint the whole ``metrics_tpu_torch`` package (default) or ``package_dir``."""
    root = package_root()
    if package_dir is None:
        package_dir = os.path.join(root, PACKAGE_NAME)
    return lint_paths(iter_package_files(package_dir), root, rules=rules)
