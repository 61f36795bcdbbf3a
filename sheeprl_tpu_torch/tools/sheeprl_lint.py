"""sheeprl-lint over the port: whole-tree static analysis of
``sheeprl_tpu_torch/`` for config contracts, journal and trace vocabularies,
env pipelining, lock discipline, instrumentation and step-body purity.

The port's counterpart of the repo's ``tools/sheeprl_lint.py`` (rule
catalog: ``howto/lint.md``), with its own copy of the passes in
``sheeprl_tpu_torch/tools/lint/``.  It is static (AST and YAML): it imports
no torch, no jax and nothing of ``sheeprl_tpu``, needs no device and runs the
same on a machine with or without a card.

* **INS** — training loops dispatch through ``diag.instrument`` and guarded
  step builders wire ``health_stats`` (INS001/003, donation, have no eager
  counterpart and never fire on the port);
* **JIT** — no host RNG / wall clocks / host syncs / prints inside the step
  bodies (``instrument``-ed functions and the ``make_train_step*`` /
  ``make_update*`` builders' results);
* **CFG** — ``cfg.*`` accesses and the YAML config tree agree (typos, dead
  keys, unquoted YAML-1.1 bools);
* **JRN** — journal event kinds and ``/metrics`` names are declared in
  ``sheeprl_tpu_torch/diagnostics/schema.py`` and documented;
* **ASY** — split-phase env discipline (async/wait pairing, single-module
  command bytes);
* **TRC** — trace hygiene (span names resolve to ``KNOWN_PHASES``, SLO
  bucket boundaries come from config);
* **LCK** — lock discipline for the threaded runtime.

Exit code is non-zero when any finding is not suppressed by the baseline.

Usage:
    python -m sheeprl_tpu_torch.tools.sheeprl_lint                   # all passes, text
    python -m sheeprl_tpu_torch.tools.sheeprl_lint --rules JIT,CFG   # subset
    python -m sheeprl_tpu_torch.tools.sheeprl_lint --jobs 4          # families in parallel
    python -m sheeprl_tpu_torch.tools.sheeprl_lint --format json     # machine-readable
    python -m sheeprl_tpu_torch.tools.sheeprl_lint --out report.json # JSON artifact (always)
    python -m sheeprl_tpu_torch.tools.sheeprl_lint --update-baseline # accept current findings
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from sheeprl_tpu_torch.tools.lint import (
    apply_baseline,
    get_passes,
    load_baseline,
    rule_catalog,
    run_passes,
    split_baseline_by_family,
    write_baseline,
)
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex

TOOLS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(TOOLS_DIR))
DEFAULT_BASELINE = os.path.join(TOOLS_DIR, "lint", "baseline.json")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated pass families to run (default: all of "
        + ",".join(get_passes())
        + ")",
    )
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE, help="JSON baseline path")
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline to the current findings (existing whys kept)",
    )
    parser.add_argument("--out", default=None, help="also write the JSON report here")
    parser.add_argument("--root", default=REPO_ROOT, help="repo root to lint")
    parser.add_argument(
        "--jobs",
        type=int,
        default=1,
        help="run pass families on N threads (they are independent read-only "
        "walks over the parsed corpus; output is identical to --jobs 1)",
    )
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(rule_catalog().items()):
            print(f"{rule}  {desc}")
        return 0

    families = None
    if args.rules:
        families = [f.strip().upper() for f in args.rules.split(",") if f.strip()]
        unknown = [f for f in families if f not in get_passes()]
        if unknown:
            parser.error(f"unknown rule families: {', '.join(unknown)} (have {', '.join(get_passes())})")

    t0 = time.monotonic()
    index = RepoIndex.from_fs(args.root)
    findings = run_passes(index, families, jobs=max(1, args.jobs))
    elapsed = time.monotonic() - t0

    baseline = load_baseline(args.baseline)
    # a --rules subset run can neither match nor stale-out entries of the
    # families it did not execute — and --update-baseline must not drop them
    in_scope, out_of_scope = split_baseline_by_family(baseline, families)
    if args.update_baseline:
        new = write_baseline(args.baseline, findings, in_scope, keep=out_of_scope)
        total = len(findings) + len(out_of_scope)
        print(
            f"sheeprl-lint: baseline rewritten with {total} entr"
            f"{'y' if total == 1 else 'ies'} ({new} new — every new entry needs its "
            f"TODO why replaced; {len(out_of_scope)} kept from families not run) "
            f"-> {args.baseline}"
        )
        return 0

    active, suppressed, stale = apply_baseline(findings, in_scope)

    report = {
        "findings": [f.as_dict() for f in active],
        "suppressed": len(suppressed),
        "stale_baseline_entries": [
            {"rule": e["rule"], "file": e["file"], "message": e["message"]} for e in stale
        ],
        "elapsed_seconds": round(elapsed, 3),
        "families": families or list(get_passes()),
    }
    if args.out:
        out_dir = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as fp:
            json.dump(report, fp, indent=2)
            fp.write("\n")

    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for finding in active:
            print(finding.render())
        status = "FAIL" if active else "OK"
        bits = [f"{len(active)} finding(s)"]
        if suppressed:
            bits.append(f"{len(suppressed)} baselined")
        if stale:
            bits.append(
                f"{len(stale)} stale baseline entr"
                f"{'y' if len(stale) == 1 else 'ies'} (run --update-baseline)"
            )
        print(
            f"sheeprl-lint: {status} — {', '.join(bits)} "
            f"[{', '.join(report['families'])}] in {elapsed:.2f}s"
        )
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
