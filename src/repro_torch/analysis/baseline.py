"""Shared suppression/baseline machinery for the port's analyzers — the
counterpart of ``repro/analysis/baseline.py``, kept as the port's own copy.

The three analyzers — ``repro_torch.analysis.lint`` (source level),
``tracekit`` (recorded calls of the fleet entries) and ``palkit`` (the
CUDA kernels) — accept debt the same way: a violation is EITHER annotated
in-tree with a reasoned allow comment OR recorded in a committed baseline
file, and the committed baselines start (and stay) empty.  This module
is the one implementation of the file format and the new-vs-accepted
diff, so the analyzers cannot drift.

Baseline format: one key per line, ``#`` comments ignored.  Keys are
line-free (``RULE path scope`` for lint, ``RULE entry detail`` for
tracekit, ``RULE kernel detail`` for palkit) so unrelated edits don't
churn the file.  Duplicate keys are counted: two accepted violations
with the same key admit exactly two occurrences, not unlimited.

Stdlib only — ``lint`` must stay importable with neither torch nor jax
installed.
"""
from __future__ import annotations

import collections
import os
from typing import Dict, List, Sequence

# Objects flowing through these helpers only need a ``.key`` str property
# (lint.Violation, tracekit.Violation, palkit.Violation).


def load_baseline(path: str) -> collections.Counter:
    base: collections.Counter = collections.Counter()
    if not os.path.exists(path):
        return base
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                base[line] += 1
    return base


def write_baseline(path: str, violations: Sequence, header: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(header)
        for v in sorted(violations, key=lambda v: v.key):
            fh.write(v.key + "\n")


def new_violations(violations: Sequence,
                   baseline: collections.Counter) -> List:
    """Violations not covered by the baseline (each baseline key admits as
    many occurrences as it is listed times)."""
    remaining = collections.Counter(baseline)
    out = []
    for v in violations:
        if remaining[v.key] > 0:
            remaining[v.key] -= 1
        else:
            out.append(v)
    return out


def per_rule_counts(violations: Sequence, rules: Dict[str, str]
                    ) -> Dict[str, int]:
    counts = {rule: 0 for rule in rules}
    for v in violations:
        counts.setdefault(v.rule, 0)
        counts[v.rule] += 1
    return counts
