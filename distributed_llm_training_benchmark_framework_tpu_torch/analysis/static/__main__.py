"""graftcheck CLI of the port.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.analysis.static --all

Exit codes (JAX's): 0 clean, 1 findings (budget deltas / lint violations),
2 operational error (an arm failed to build, bad usage).

The counterpart of ``distributed_llm_training_benchmark_framework_tpu/
analysis/static/__main__.py``, with every flag. The audit runs on the CPU
on a fake process group (``collective_audit``): it needs no card and never
initializes CUDA, which it shows by printing ``torch.cuda.is_initialized()``
on stderr at its end. The port's bench runs ``--lint --audit --arms
llama-tp2-gqa`` in a child process before any arm (``bench.run_preflight``).
The budgets record the torch version they were frozen on; on another
version the audit compares all the same and says so beside its findings
(the port's counts come from its own code and torch's DDP / FSDP2, which
issue the same collectives from one version to the next far more often
than a compiler's schedule stays put).
"""

import argparse
import os
import sys




def _git_changed_files():
    """Repo-relative paths changed vs the merge-base with the default
    branch, plus staged/unstaged/untracked work. Tuple (possibly empty);
    None only when git itself is unavailable — the caller then falls
    back to a full lint rather than silently passing.
    """
    import subprocess

    from .collective_audit import REPO_ROOT

    def git(*a):
        try:
            out = subprocess.run(
                ["git", *a], cwd=REPO_ROOT, capture_output=True,
                text=True, timeout=30,
            )
        except Exception:
            return None
        return out.stdout if out.returncode == 0 else None

    if git("rev-parse", "HEAD") is None:
        # No git (or not a repo): the caller must fall back to a FULL
        # lint — an empty changed set here would pass the pre-commit
        # hook without linting anything.
        return None
    # git emits toplevel-relative paths; Violation.path is
    # REPO_ROOT-relative. When this checkout is a SUBDIRECTORY of a
    # larger repo the two bases differ, and comparing them unrebased
    # would scope every finding to nothing — the same silent-pass mode
    # as the no-git case. Rebase (and drop files outside this project).
    toplevel = (git("rev-parse", "--show-toplevel") or "").strip()
    prefix = ""
    if toplevel:
        rel = os.path.relpath(os.path.abspath(REPO_ROOT), toplevel)
        if rel not in (".", ""):
            if rel.startswith(".."):
                return None  # REPO_ROOT outside the repo git sees: full lint
            prefix = rel.replace(os.sep, "/") + "/"

    def rebase(path):
        path = path.replace(os.sep, "/")
        if not prefix:
            return path
        if path.startswith(prefix):
            return path[len(prefix):]
        return None
    base = None
    for ref in ("origin/main", "origin/master", "main", "master"):
        out = git("merge-base", "HEAD", ref)
        if out and out.strip():
            base = out.strip()
            break
    files = set()
    # Committed + working-tree changes vs the merge-base (diff against a
    # commit includes staged AND unstaged edits), plus untracked files.
    # `git diff` paths are toplevel-relative regardless of cwd;
    # `ls-files` paths are cwd-relative, so run everything from
    # REPO_ROOT (the subprocess cwd above) and rebase the diff output.
    if base:
        out = git("diff", "--name-only", base)
    else:
        out = git("diff", "--name-only", "HEAD")
    if out:
        files.update(
            r for l in out.splitlines() if l.strip()
            for r in (rebase(l.strip()),) if r is not None
        )
    out = git("ls-files", "--others", "--exclude-standard")
    if out:
        # cwd-relative (== REPO_ROOT-relative) already.
        files.update(
            l.strip().replace(os.sep, "/")
            for l in out.splitlines() if l.strip()
        )
    return tuple(sorted(files))




def _arm_names(requested, *rosters):
    """(the names in each roster, the unknown names) of a --arms list."""
    return ([[n for n in requested if n in r] for r in rosters],
            [n for n in requested if not any(n in r for r in rosters)])


def _version_note(frozen, what: str) -> None:
    from .collective_audit import _torch_version

    if frozen is not None and frozen != _torch_version():
        print(f"graftcheck {what}: budgets frozen on torch {frozen}, running torch "
              f"{_torch_version()} — compared as they are; a count that moved may be the "
              "version's (regenerate with --update-budgets on this version)", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llm_training_benchmark_framework_tpu_torch"
             ".analysis.static",
        description="graftcheck: collective-budget audit on a fake process group + the "
                    "port's hot-path lint",
    )
    p.add_argument("--all", action="store_true",
                   help="run both engines over the full arm roster, and the default "
                        "world tiers")
    p.add_argument("--audit", action="store_true",
                   help="run the collective-budget audit")
    p.add_argument("--lint", action="store_true",
                   help="run the AST lint rules")
    p.add_argument("--changed", action="store_true",
                   help="fast pre-commit mode: lint ONLY files changed vs "
                        "the merge-base with the default branch (plus "
                        "staged/unstaged/untracked work) — no audits. "
                        "Rules still read unchanged files for context; "
                        "findings are scoped to the changed set")
    p.add_argument("--memory", action="store_true",
                   help="GC110 memory-budget audit: every roster arm's rank-0 state "
                        "(params, grads, optimizer state) and live-storage peak over one "
                        "step, against the frozen memory_budgets section, plus the "
                        "cross-tier laws (per-rank temps flat along data; fsdp/zero state "
                        "shrinking). With --topology TIERS, those tiers are audited "
                        "fresh; with --update-budgets, freezes the memory_budgets section "
                        "(only)")
    p.add_argument("--arms", default=None,
                   help="comma-separated arm subset for --audit/--memory/--topology "
                        "(default: the whole roster)")
    p.add_argument("--topology", default=None,
                   help="comma-separated world tier(s) (world-16|world-64|world-256): the "
                        "scalable roster subset as rank 0 of a fake group of that many "
                        "ranks, against per-tier budgets and the growth laws. --all "
                        "includes the default tiers (world-16,world-64)")
    p.add_argument("--list-arms", action="store_true",
                   help="print the audit roster and exit")
    p.add_argument("--list-rules", action="store_true",
                   help="print the lint rule catalog and exit")
    p.add_argument("--budgets", default=None,
                   help="budgets file (default: configs/collective_budgets_torch.json)")
    p.add_argument("--update-budgets", action="store_true",
                   help="regenerate the budgets file from fresh audits "
                        "instead of diffing against it")
    p.add_argument("--json", action="store_true",
                   help="emit the audit reports as JSON on stdout")
    p.add_argument("--inject", default=None,
                   choices=["bad-kv-spec", "bad-fsdp-axis", "bad-pipeline-spec",
                            "bad-forward-gather", "bad-cmm-ring"],
                   help="self-test: deliberately reintroduce a known-bad "
                        "configuration (bad-kv-spec = llama's K/V projection split by "
                        "columns and gathered over 'model'; bad-fsdp-axis = FSDP2 over the "
                        "whole group instead of 'data'; bad-pipeline-spec = one extra "
                        "pipeline message per micro-batch; bad-forward-gather = fsdp/zero3 "
                        "gathering every block before the forward; bad-cmm-ring = the "
                        "collective matmul's ring as bulk collectives) — the audit MUST "
                        "then fail")
    args = p.parse_args(argv)

    if args.changed and (args.all or args.audit or args.topology
                         or args.memory or args.update_budgets):
        p.error("--changed is the fast lint-only pre-commit path; run the "
                "audits separately (--all / --audit / --topology)")
    if args.inject and args.update_budgets:
        p.error("--inject is a self-test knob and cannot be combined with "
                "--update-budgets")
    if args.arms and args.topology and args.update_budgets:
        p.error("--arms with --topology --update-budgets would freeze a "
                "partial tier; freeze whole tiers")
    try:
        return _run(p, args)
    finally:
        import torch

        print(f"graftcheck: torch.cuda.is_initialized() = {torch.cuda.is_initialized()}",
              file=sys.stderr)


def _run(p, args) -> int:
    import torch

    from . import collective_audit as audit
    from . import lint

    # Tier S steps are too small to gain from intra-op threads (and the
    # counts do not depend on them).
    torch.set_num_threads(1)

    if args.list_rules:
        for rule in lint.RULES.values():
            print(f"{rule.id}  {rule.name}")
            print(f"       {rule.description}")
            print(f"       fix: {rule.fix_hint}")
        print("GC110  memory-budget-audit")
        print("       the memory audit (--memory), not a lint rule: rank 0's state and "
              "live-storage peak per arm against the frozen memory_budgets, and the "
              "cross-tier laws")
        print("       fix: find the replicated state or the grown temporary the finding "
              "names; bank an improvement with --memory --update-budgets")
        return 0
    if args.list_arms:
        for spec in audit.ROSTER.values():
            geom = "x".join(map(str, spec.mesh_shape))
            print(f"{spec.name}: {spec.strategy} x {spec.model_family} x "
                  f"mesh {geom} {spec.axes}")
        for spec in audit.PIPELINE_ROSTER.values():
            geom = "x".join(map(str, spec.mesh_shape))
            print(f"[pipeline] {spec.name}: {spec.pipeline_schedule} "
                  f"(V={spec.virtual_stages}) x {spec.model_family} x "
                  f"mesh {geom} M={spec.grad_accum}")
        for tier in audit.TOPOLOGY_TIERS.values():
            print(f"[topology] {tier.name}: {tier.nodes} nodes x 8 H100 "
                  f"({tier.device_count} ranks; arms {', '.join(audit.TOPOLOGY_ARMS)})")
        for name, why in audit.NOT_AUDITED.items():
            print(f"[not audited] {name}: {why}")
        return 0

    topo_tiers = ([t.strip() for t in args.topology.split(",") if t.strip()]
                  if args.topology else [])
    unknown_tiers = [t for t in topo_tiers if t not in audit.TOPOLOGY_TIERS]
    if unknown_tiers:
        print(f"graftcheck: unknown topology tier(s) {unknown_tiers}; "
              f"tiers: {list(audit.TOPOLOGY_TIERS)}", file=sys.stderr)
        return 2

    # JAX's flag semantics: --topology alone runs only the tier audit, and
    # --memory claims --topology for itself; a freeze of one section never
    # regenerates another.
    do_memory = args.memory
    do_audit = (args.all or args.audit
                or (args.update_budgets and not topo_tiers and not args.memory))
    do_lint = args.all or args.lint or args.changed
    do_topology = (bool(topo_tiers) and not args.memory) or args.all
    if not (do_audit or do_lint or do_topology or do_memory):
        p.error("nothing to do: pass --all, --audit, --lint, --changed, "
                "--memory, --topology or --update-budgets")

    failures = 0
    budgets_path = args.budgets or audit.DEFAULT_BUDGETS_PATH

    if do_lint:
        changed_files = None
        if args.changed:
            changed_files = _git_changed_files()
            if changed_files is None:
                print("graftcheck lint: --changed cannot reach git; "
                      "falling back to a FULL lint", file=sys.stderr)
            elif not changed_files:
                print("graftcheck lint: no changed files vs merge-base — "
                      "clean", file=sys.stderr)
                return 0
            else:
                print(f"graftcheck lint: --changed scoping to "
                      f"{len(changed_files)} file(s)", file=sys.stderr)
        violations = lint.run_lint(files=changed_files)
        for v in violations:
            print(str(v), file=sys.stderr)
        n = len(violations)
        print(f"graftcheck lint: {n} violation(s) across {len(lint.RULES)} rules" if n else
              f"graftcheck lint: clean ({len(lint.RULES)} rules)", file=sys.stderr)
        failures += n

    if do_audit:
        if args.arms:
            requested = [a.strip() for a in args.arms.split(",") if a.strip()]
            (names, pipe_names), unknown = _arm_names(requested, audit.ROSTER,
                                                      audit.PIPELINE_ROSTER)
            if unknown:
                print(f"graftcheck: unknown arm(s) {unknown}; roster: "
                      f"{list(audit.ROSTER)} + pipeline roster: "
                      f"{list(audit.PIPELINE_ROSTER)}", file=sys.stderr)
                return 2
        else:
            names, pipe_names = list(audit.ROSTER), list(audit.PIPELINE_ROSTER)

        import dataclasses as _dc

        reports = []
        for name in names:
            spec = audit.ROSTER[name]
            if args.inject:
                spec = _dc.replace(spec, inject=args.inject)
            print(f"graftcheck audit: stepping {name} on a fake group of "
                  f"{spec.world} ...", file=sys.stderr)
            try:
                reports.append(audit.audit_arm(spec))
            except Exception as e:
                print(f"graftcheck audit: arm {name} failed to build: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                return 2
        pipe_results = []
        for name in pipe_names:
            spec = audit.PIPELINE_ROSTER[name]
            if args.inject:
                spec = _dc.replace(spec, inject=args.inject)
            m2 = spec.grad_accum * audit.PIPELINE_GROWTH_M_FACTOR
            print(f"graftcheck audit: stepping {name} (schedule laws, "
                  f"M={spec.grad_accum} and M={m2}) ...", file=sys.stderr)
            # A failure is a schedule-compiles finding (exit 1), as in JAX.
            pipe_results.append(audit.audit_pipeline_arm(spec))

        if args.json:
            import json as _json

            doc = {r.arm: r.to_budget_entry() for r in reports}
            doc.update({
                r.arm: (r.to_budget_entry() if r.compile_error is None
                        else {"compile_error": r.compile_error})
                for r in pipe_results
            })
            print(_json.dumps(doc, indent=2, sort_keys=True))

        if args.update_budgets:
            existing = audit.load_budgets(budgets_path) if os.path.exists(budgets_path) else None
            if reports:
                existing = audit.write_budgets(reports, budgets_path, existing=existing)
                print(f"graftcheck audit: froze {len(reports)} arm "
                      f"budget(s) into {budgets_path}", file=sys.stderr)
            if pipe_results:
                audit.write_pipeline_budgets(pipe_results, budgets_path, existing=existing)
                print(f"graftcheck audit: froze {len(pipe_results)} "
                      f"pipeline_schedules budget(s) into {budgets_path}", file=sys.stderr)
        else:
            if not os.path.exists(budgets_path):
                print(f"graftcheck audit: no budgets file at {budgets_path} "
                      "(run --update-budgets first)", file=sys.stderr)
                return 2
            budgets = audit.load_budgets(budgets_path)
            deltas = []
            for rep in reports:
                deltas.extend(audit.diff_against_budget(rep, budgets))
            for r in pipe_results:
                deltas.extend(audit.diff_pipeline_against_budget(r, budgets))
            for d in deltas:
                print(f"graftcheck audit: {d}", file=sys.stderr)
            if deltas:
                _version_note(budgets.get("torch_version"), "audit")
            print(f"graftcheck audit: {len(reports)} arm(s) + "
                  f"{len(pipe_results)} pipeline arm(s), "
                  f"{len(deltas)} finding(s)", file=sys.stderr)
            failures += len(deltas)

    if do_topology:
        tiers = topo_tiers or list(audit.TOPOLOGY_DEFAULT_TIERS)
        topo_arm_names = None
        if args.arms and topo_tiers:
            requested = [a.strip() for a in args.arms.split(",") if a.strip()]
            unknown = [n for n in requested if n not in audit.TOPOLOGY_ARMS]
            if unknown:
                print(f"graftcheck topology: unknown arm(s) {unknown}; "
                      f"topology roster: {list(audit.TOPOLOGY_ARMS)}", file=sys.stderr)
                return 2
            topo_arm_names = tuple(requested)
        fresh = {}
        try:
            for tier_name in tiers:
                tier = audit.TOPOLOGY_TIERS[tier_name]
                n_arms = len(topo_arm_names or audit.TOPOLOGY_ARMS)
                print(f"graftcheck topology: stepping {n_arms} arm(s) as rank 0 of "
                      f"{tier_name} ({tier.device_count} ranks) ...", file=sys.stderr)
                fresh[tier_name] = audit.audit_topology_tier(
                    tier, arm_names=topo_arm_names, inject=args.inject)
        except Exception as e:
            print(f"graftcheck topology: arm failed to build: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 2
        if args.json:
            import json as _json

            print(_json.dumps({t: {r.arm: r.to_budget_entry() for r in reps}
                               for t, reps in fresh.items()}, indent=2, sort_keys=True))
        if args.update_budgets and topo_tiers:
            doc = audit.write_topology_budgets(fresh, budgets_path)
            print(f"graftcheck topology: froze {len(fresh)} tier "
                  f"budget(s) into {budgets_path}", file=sys.stderr)
            growth_doc, _stale = audit.commensurable_topology_tiers(
                doc, fresh_tiers=tuple(fresh))
            for g in audit.growth_law_findings(audit.assemble_per_tier(growth_doc)):
                print(f"graftcheck topology: WARNING (frozen anyway): {g}", file=sys.stderr)
        else:
            budgets = audit.load_budgets(budgets_path) if os.path.exists(budgets_path) else {}
            deltas = []
            for tier_name, reports in fresh.items():
                deltas.extend(audit.diff_topology_against_budget(tier_name, reports, budgets))
            # The laws judge the fresh tiers over every other tier's frozen
            # counts, of this torch version only.
            growth_budgets, stale_tiers = audit.commensurable_topology_tiers(
                budgets, fresh_tiers=tuple(fresh))
            if stale_tiers:
                print("graftcheck topology: growth laws exclude "
                      f"tier(s) {stale_tiers} frozen on another torch — regenerate them "
                      f"with --topology {','.join(stale_tiers)} --update-budgets",
                      file=sys.stderr)
            deltas.extend(audit.growth_law_findings(
                audit.assemble_per_tier(growth_budgets, fresh)))
            for d in deltas:
                print(f"graftcheck topology: {d}", file=sys.stderr)
            if deltas:
                for tier_name in fresh:
                    _version_note(budgets.get("world_tiers", {}).get(tier_name, {})
                                  .get("torch_version"), "topology")
            print(f"graftcheck topology: {len(fresh)} tier(s), "
                  f"{len(deltas)} finding(s)", file=sys.stderr)
            failures += len(deltas)

    if do_memory:
        if args.arms:
            mem_names = [a.strip() for a in args.arms.split(",") if a.strip()]
            unknown = [n for n in mem_names if n not in audit.ROSTER]
            if unknown:
                print(f"graftcheck memory: unknown arm(s) {unknown}; "
                      f"roster: {list(audit.ROSTER)}", file=sys.stderr)
                return 2
        else:
            mem_names = list(audit.ROSTER)

        import dataclasses as _dc

        mem_reports = []
        for name in mem_names:
            spec = audit.ROSTER[name]
            if args.inject:
                spec = _dc.replace(spec, inject=args.inject)
            print(f"graftcheck memory: stepping {name} ...", file=sys.stderr)
            try:
                mem_reports.append(audit.audit_arm_memory(spec))
            except Exception as e:
                print(f"graftcheck memory: arm {name} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                return 2
        fresh_mem_tiers = {}
        try:
            for tier_name in topo_tiers:
                tier = audit.TOPOLOGY_TIERS[tier_name]
                print(f"graftcheck memory: stepping {len(audit.TOPOLOGY_ARMS)} arm(s) as "
                      f"rank 0 of {tier_name} ...", file=sys.stderr)
                fresh_mem_tiers[tier_name] = audit.audit_topology_tier_memory(
                    tier, inject=args.inject)
        except Exception as e:
            print(f"graftcheck memory: tier arm failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
        for r in mem_reports:
            print(f"graftcheck memory: {r.arm}: state {r.argument_bytes} B, peak "
                  f"{r.peak_bytes} B, utils/memory estimate {r.estimate_bytes} B "
                  f"(drift {r.estimate_drift_frac:+.4f} of the peak)", file=sys.stderr)
        if args.json:
            import json as _json

            doc = {r.arm: r.to_budget_entry() for r in mem_reports}
            doc.update({t: {r.arm: r.to_budget_entry() for r in reps}
                        for t, reps in fresh_mem_tiers.items()})
            print(_json.dumps(doc, indent=2, sort_keys=True))
        if args.update_budgets:
            audit.write_memory_budgets(mem_reports, budgets_path, tier_reports=fresh_mem_tiers)
            print(f"graftcheck memory: froze {len(mem_reports)} arm + "
                  f"{len(fresh_mem_tiers)} tier memory budget(s) into "
                  f"{budgets_path}", file=sys.stderr)
            per_tier, _stale = audit.commensurable_memory_tiers(
                audit.load_budgets(budgets_path), fresh_tiers=tuple(fresh_mem_tiers))
            for g in audit.memory_growth_law_findings(per_tier):
                print(f"graftcheck memory: WARNING (frozen anyway): {g}", file=sys.stderr)
        else:
            if not os.path.exists(budgets_path):
                print(f"graftcheck memory: no budgets file at "
                      f"{budgets_path} (run --memory --update-budgets "
                      "first)", file=sys.stderr)
                return 2
            budgets = audit.load_budgets(budgets_path)
            section = budgets.get("memory_budgets", {})
            deltas = []
            for rep in mem_reports:
                deltas.extend(audit.diff_memory_against_budget(rep, budgets))
            per_tier, stale_tiers = audit.commensurable_memory_tiers(
                budgets, fresh_tiers=tuple(fresh_mem_tiers))
            if stale_tiers:
                print("graftcheck memory: growth laws exclude tier(s) "
                      f"{stale_tiers} frozen on another torch — regenerate with "
                      f"--memory --topology {','.join(stale_tiers)} --update-budgets",
                      file=sys.stderr)
            for tier_name, reps in fresh_mem_tiers.items():
                frozen_arms = per_tier.get(tier_name, {})
                for rep in reps:
                    deltas.extend(audit.diff_memory_against_budget(
                        rep, budgets, arms_override=frozen_arms))
                per_tier.setdefault(tier_name, {}).update(
                    {r.arm: r.to_budget_entry() for r in reps})
            deltas.extend(audit.memory_growth_law_findings(per_tier))
            for d in deltas:
                print(f"graftcheck memory: {d}", file=sys.stderr)
            if deltas:
                _version_note(section.get("torch_version"), "memory")
            print(f"graftcheck memory: {len(mem_reports)} arm(s) + "
                  f"{len(fresh_mem_tiers) or len(per_tier)} tier(s), "
                  f"{len(deltas)} finding(s)", file=sys.stderr)
            failures += len(deltas)

    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
