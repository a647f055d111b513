"""Static and runtime invariant checks over the port (port of
``paddle_tpu/analysis/``).

Three pillars; the first two run over ``paddle_tpu_torch``'s own sources:

* :mod:`~paddle_tpu_torch.analysis.lint` — an AST repo-invariant linter
  (zero third-party deps): hidden host syncs, non-atomic writes,
  wall-clock deadlines, unregistered ``FLAGS_*`` and counters, bare
  excepts, out-of-memory handlers that bypass the classifier. Inline
  suppression via ``# lint: ok(<rule>)``; grandfathered findings live in
  ``baseline.txt`` with one-line justifications.
* :mod:`~paddle_tpu_torch.analysis.locks` — a lock-discipline checker over
  ``# guarded_by: <lock>`` annotations, plus the opt-in runtime
  ownership-assertion mode in
  :mod:`~paddle_tpu_torch.analysis.thread_checks` (``FLAGS_thread_checks``)
  that makes races fail deterministically.

* :mod:`~paddle_tpu_torch.analysis.verify_graph` — the lazy engine's
  pending-graph verifier (``FLAGS_lazy_verify``): wiring, leaf table,
  donation, signature, the deferred queue and, before a CUDA graph
  replays, the addresses of the leaves it binds.

``python -m paddle_tpu_torch.analysis`` runs the first two and exits non-zero on any
unsuppressed finding; a tier-1 test holds the tree clean.
"""
from __future__ import annotations

import os
from typing import List, Optional

from .lint import Finding, lint_package, load_baseline  # noqa: F401
from .locks import check_lock_discipline  # noqa: F401

__all__ = [
    "Finding", "lint_package", "check_lock_discipline", "run_all",
    "package_root", "baseline_path",
]


def package_root() -> str:
    """The paddle_tpu_torch package directory the analysis runs over."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.txt")


def run_all(root: Optional[str] = None,
            baseline: Optional[str] = None) -> List[Finding]:
    """Run both pillars over ``root`` (default: the installed
    paddle_tpu_torch package) and return the UNSUPPRESSED findings."""
    root = root or package_root()
    if baseline is None:
        baseline = baseline_path()
    base = load_baseline(baseline) if baseline and os.path.exists(
        baseline) else []
    findings = lint_package(root, baseline=base)
    findings += check_lock_discipline(root, baseline=base)
    return findings
