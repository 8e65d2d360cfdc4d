"""CLI for the port's analysis passes (counterpart of
``metrics_tpu/analysis/__main__.py``): ``python -m metrics_tpu_torch.analysis``.

Subcommands::

    python -m metrics_tpu_torch.analysis lint     # AST rules over metrics_tpu_torch/
    python -m metrics_tpu_torch.analysis locks    # lock-order graph vs the port's LOCK_ORDER.md
    python -m metrics_tpu_torch.analysis audit    # the registry's step budgets
    python -m metrics_tpu_torch.analysis all      # all three
    python -m metrics_tpu_torch.analysis profile  # per-entry cost table: flops, bytes
                                                  # accessed, collective payload bytes,
                                                  # wall p50/p99 (and the card's time)
    python -m metrics_tpu_torch.analysis rules    # the rule catalog

Lint findings print as ``path:line:col: RULEID message``; the exit code is
1 when any NEW finding (not in the port's baseline,
``metrics_tpu_torch/analysis/lint_baseline.txt``), lock-order violation or
budget violation exists. ``--write-baseline`` regenerates the port's
baseline from the current findings (never the repo-root
``lint_baseline.txt``, which is the JAX package's).

``audit`` and ``profile`` run on ``--device`` (CUDA by default; without a
card they raise, ROADMAP D53): ``--device cpu`` runs them on the CPU.
``profile`` writes ``metrics_tpu_torch/analysis/COST_PROFILE.json``
(git-ignored) unless ``--out`` names another file or ``--no-write``.
"""
import argparse
import sys


def _cmd_lint(args: argparse.Namespace) -> int:
    from metrics_tpu_torch.analysis.baseline import (
        apply_baseline,
        default_baseline_path,
        load_baseline,
        save_baseline,
    )
    from metrics_tpu_torch.analysis.lint import lint_package

    findings = lint_package()
    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        save_baseline(baseline_path, findings)
        print(f"graft-lint: wrote {len(findings)} finding(s) to {baseline_path}")
        return 0
    new, stale = apply_baseline(findings, load_baseline(baseline_path))
    for f in new:
        print(f.format())
    if stale:
        print(
            f"graft-lint: {sum(stale.values())} stale baseline entr(y/ies) — debt paid "
            f"down; prune {baseline_path}:",
            file=sys.stderr,
        )
        for fp in sorted(stale):
            print(f"  {fp}", file=sys.stderr)
    grandfathered = len(findings) - len(new)
    print(f"graft-lint: {len(new)} new finding(s), {grandfathered} grandfathered (baseline: {baseline_path})")
    return 1 if new else 0


def _cmd_locks(args: argparse.Namespace) -> int:
    from metrics_tpu_torch.analysis.concurrency import (
        analyze_package,
        check_manifest,
        default_manifest_path,
        render_report,
    )

    report = analyze_package()
    manifest_path = args.manifest or default_manifest_path()
    try:
        with open(manifest_path, "r", encoding="utf-8") as fh:
            manifest_text = fh.read()
    except FileNotFoundError:
        print(f"lock-order: manifest {manifest_path} missing", file=sys.stderr)
        return 1
    violations = check_manifest(report, manifest_text)
    print(render_report(report, violations))
    return 1 if violations else 0


def _cmd_audit(args: argparse.Namespace) -> int:
    from metrics_tpu_torch.analysis.registry import REGISTRY, resolve_device, run_graph_audit

    device = resolve_device(args.device)
    violations = run_graph_audit(ndev=args.mesh_ndev, device=device)
    for v in violations:
        print(v.format())
    print(
        f"graph-audit: {len(violations)} violation(s) across {len(REGISTRY)} registry entr(y/ies), "
        f"a mirrored world of {args.mesh_ndev} on {device}"
    )
    return 1 if violations else 0


def _cmd_profile(args: argparse.Namespace) -> int:
    from metrics_tpu_torch.analysis.registry import REGISTRY, resolve_device
    from metrics_tpu_torch.obs.profile import profile_registry, render_table, write_profile

    device = resolve_device(args.device)
    entries = None
    if args.entry:
        by_name = {e.name: e for e in REGISTRY}
        unknown = sorted(set(args.entry) - set(by_name))
        if unknown:
            print(f"profile: unknown entr(y/ies) {unknown} — have {sorted(by_name)}", file=sys.stderr)
            return 1
        entries = tuple(by_name[name] for name in args.entry)
    doc = profile_registry(entries, ndev=args.mesh_ndev, reps=args.reps, device=device)
    print(render_table(doc))
    if not args.no_write:
        path = write_profile(doc, args.out)
        print(f"profile: wrote {len(doc['entries'])} entr(y/ies) to {path}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.analysis",
        description="graft-lint for the port: AST lint, lock order, step-budget audit, cost profile",
    )
    parser.add_argument(
        "command",
        nargs="?",
        default="all",
        choices=("lint", "locks", "audit", "all", "rules", "profile"),
        help="which pass to run (default: all = lint, locks and audit); `locks` checks the lock-order "
        "graph against metrics_tpu_torch/analysis/LOCK_ORDER.md; `rules` prints the rule catalog; "
        "`profile` writes the per-entry cost table",
    )
    parser.add_argument("--baseline", help="baseline file path (default: metrics_tpu_torch/analysis/lint_baseline.txt)")
    parser.add_argument("--manifest", help="lock-hierarchy manifest path (default: metrics_tpu_torch/analysis/LOCK_ORDER.md)")
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="regenerate the port's baseline from current findings instead of failing on them",
    )
    parser.add_argument("--device", help="device of `audit` and `profile` (default: cuda; `cpu` on a machine without a card)")
    parser.add_argument("--mesh-ndev", type=int, default=4, help="size of the mirrored world the syncs run in (default 4)")
    parser.add_argument("--reps", type=int, default=20, help="wall-time samples per profiled entry (default 20)")
    parser.add_argument("--entry", action="append", help="profile only this registry entry (repeatable; default: all)")
    parser.add_argument("--out", help="cost-table output path (default: metrics_tpu_torch/analysis/COST_PROFILE.json)")
    parser.add_argument("--no-write", action="store_true", help="print the table without writing the JSON")
    args = parser.parse_args(argv)

    if args.command == "rules":
        from metrics_tpu_torch.analysis.rules import ALL_RULES

        for rule in ALL_RULES:
            print(f"{rule.rule_id}  {rule.name}\n    {rule.description}")
        return 0

    if args.command == "profile":
        return _cmd_profile(args)

    rc = 0
    if args.command in ("lint", "all"):
        rc |= _cmd_lint(args)
    if args.command in ("locks", "all"):
        rc |= _cmd_locks(args)
    if args.command in ("audit", "all"):
        rc |= _cmd_audit(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
