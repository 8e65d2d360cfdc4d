"""The lint baseline (counterpart of ``metrics_tpu/analysis/baseline.py``):
grandfathered findings, kept in the port's own file
``metrics_tpu_torch/analysis/lint_baseline.txt`` (the repo-root
``lint_baseline.txt`` is the JAX package's, and ``--write-baseline`` here
never touches it).

The baseline lets the linter land strict while known findings are
grandfathered: ``apply_baseline`` subtracts known findings so only NEW
violations fail the run. Fingerprints are ``rule_id | path | stripped
source line`` — deliberately line-number-free, so editing an unrelated part
of a file does not stale the baseline — with a count per fingerprint to
handle identical lines appearing more than once in one file.

Format (one entry per line, ``|``-separated, ``#`` comments)::

    # why this entry is provably benign (kept across --write-baseline)
    GL501|metrics_tpu_torch/foo.py|1|path = os.environ.get("X")

Every grandfathered entry MUST carry a comment block naming why it is
benign — the baseline is an annotated debt ledger, not a landfill.
``--write-baseline`` regeneration is deterministic (sorted findings,
normalized snippets, atomic write, byte-stable across runs), preserves
those per-entry comment blocks by fingerprint, and prunes entries whose
source no longer produces the finding — so a diff of the baseline in
review shows exactly the debt taken on or paid down.
"""
import os
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from metrics_tpu_torch.analysis.lint import Finding

BASELINE_FILENAME = "lint_baseline.txt"
_HEADER = (
    "# graft-lint baseline: grandfathered findings (rule_id|path|count|snippet).\n"
    "# Entries here are known debt — new findings still fail\n"
    "# `python -m metrics_tpu_torch.analysis lint`.\n"
    "# Regenerate with: python -m metrics_tpu_torch.analysis lint --write-baseline\n"
)


def default_baseline_path() -> str:
    """The port's baseline, beside this module (never the repo-root file)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), BASELINE_FILENAME)


def fingerprint(finding: Finding) -> str:
    # collapse internal whitespace so formatting-only edits don't stale entries
    snippet = " ".join(finding.snippet.split())
    return f"{finding.rule_id}|{finding.path}|{snippet}"


def load_baseline(path: str) -> Counter:
    """Fingerprint -> grandfathered occurrence count. Missing file = empty."""
    counts: Counter = Counter()
    if not os.path.exists(path):
        return counts
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("|", 3)
            if len(parts) != 4:
                raise ValueError(f"malformed baseline entry in {path}: {line!r}")
            rule_id, rel, count, snippet = parts
            # same normalization as fingerprint(): a hand-copied entry with
            # the source's real spacing must still match
            snippet = " ".join(snippet.split())
            counts[f"{rule_id}|{rel}|{snippet}"] += int(count)
    return counts


def _entry_comments(path: str) -> Dict[str, List[str]]:
    """fingerprint -> the contiguous ``#`` comment block directly above
    that entry in the existing file (header lines excluded), so hand-written
    benign-why annotations survive ``--write-baseline`` regeneration."""
    header_lines = {line for line in _HEADER.splitlines()}
    out: Dict[str, List[str]] = {}
    if not os.path.exists(path):
        return out
    block: List[str] = []
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            stripped = line.strip()
            if stripped.startswith("#"):
                if stripped not in header_lines:
                    block.append(line)
                continue
            if not stripped:
                block = []
                continue
            parts = stripped.split("|", 3)
            if len(parts) == 4 and block:
                rule_id, rel, _, snippet = parts
                snippet = " ".join(snippet.split())
                out[f"{rule_id}|{rel}|{snippet}"] = block
            block = []
    return out


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Deterministic regeneration: sorted fingerprints, normalized
    snippets, per-entry comments preserved, stale entries pruned (only
    fingerprints the CURRENT findings produce are written), and the write
    itself goes through the atomic tmp+fsync+rename path — byte-stable
    across runs of the same tree."""
    counts = Counter(fingerprint(f) for f in findings)
    comments = _entry_comments(path)
    lines: List[str] = [_HEADER]
    for fp in sorted(counts):
        for comment in comments.get(fp, ()):
            lines.append(comment + "\n")
        rule_id, rel, snippet = fp.split("|", 2)
        lines.append(f"{rule_id}|{rel}|{counts[fp]}|{snippet}\n")
    from metrics_tpu_torch.resilience.snapshot import atomic_write_bytes

    atomic_write_bytes(path, "".join(lines).encode("utf-8"))


def apply_baseline(
    findings: List[Finding], baseline: Counter
) -> Tuple[List[Finding], Dict[str, int]]:
    """Split findings into (new, grandfathered-count-by-fingerprint).

    Each baseline occurrence absorbs one matching finding; the remainder are
    new and should fail the run. Also usable to spot STALE baseline entries:
    leftover counts in the returned dict mean the debt was paid down and the
    entry can be deleted.
    """
    remaining = Counter(baseline)
    new: List[Finding] = []
    for f in findings:
        fp = fingerprint(f)
        if remaining[fp] > 0:
            remaining[fp] -= 1
        else:
            new.append(f)
    stale = {fp: n for fp, n in remaining.items() if n > 0}
    return new, stale
