"""``python -m paddle_tpu_torch.analysis`` — run the linter and the lock
checker over the package tree, exit non-zero on any unsuppressed finding.

Flags::

    python -m paddle_tpu_torch.analysis [--root DIR] [--no-baseline]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from . import package_root, run_all

    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.analysis")
    ap.add_argument("--root", default=None, help="package dir to analyze")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report grandfathered findings too")
    args = ap.parse_args(argv)

    root = args.root or package_root()
    findings = run_all(root, baseline="" if args.no_baseline else None)
    for f in findings:
        print(f)
    if findings:
        print(f"\n{len(findings)} unsuppressed finding(s) "
              f"(suppress inline with '# lint: ok(<rule>)' or baseline with "
              "a justification in paddle_tpu_torch/analysis/baseline.txt)")
        return 1
    print(f"analysis clean over {root}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
