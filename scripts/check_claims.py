"""Claims-equal-artifacts check.

Every artifact filename mentioned in the published documents must exist
as a committed file, unless the mention is an explicit retraction.

Checks:
  1. Every `*_rN.{csv,json,txt}` / `BENCH_*` / `MULTICHIP_*` name
     mentioned in README.md, ROADMAP.md, PARITY.md, BASELINE.md,
     PERF.md, CHANGES.md and docs/*.md resolves to a file in the tree
     (searched at the repo root).
  2. Retraction lines (containing one of the RETRACTION_MARKERS) are
     exempt — a correction must be able to NAME the missing file.

Run before publishing a claim:
    python scripts/check_claims.py        # exit 0 = claims match tree
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = [
    "README.md",
    "ROADMAP.md",
    "PARITY.md",
    "BASELINE.md",
    "PERF.md",
    "CHANGES.md",
]

# artifact-looking filenames: experiment outputs and driver captures
ARTIFACT_RE = re.compile(
    r"\b((?:[A-Za-z0-9_]+_r\d+[a-z]?|BENCH_r\d+|MULTICHIP_r\d+|COPYCHECK)"
    r"\.(?:csv|json|txt))\b"
)

# a line carrying one of these markers may name a file that does not
# exist — that is the point of a retraction
RETRACTION_MARKERS = (
    "FALSE",
    "retracted",
    "never existed",
    "never produced",
    "no such file",
    "crashed",
    "does not exist",
    "was missing",
)

SEARCH_DIRS = [""]


def find_artifact(name: str) -> str | None:
    for d in SEARCH_DIRS:
        p = os.path.join(REPO, d, name)
        if os.path.exists(p):
            return p
    return None


def doc_paths() -> list[str]:
    out = [os.path.join(REPO, d) for d in DOCS]
    docs_dir = os.path.join(REPO, "docs")
    if os.path.isdir(docs_dir):
        out += [
            os.path.join(docs_dir, f)
            for f in sorted(os.listdir(docs_dir))
            if f.endswith(".md")
        ]
    return [p for p in out if os.path.exists(p)]


def main() -> int:
    failures: list[str] = []

    # every mentioned artifact exists (or the line is a retraction)
    for path in doc_paths():
        rel = os.path.relpath(path, REPO)
        with open(path) as fh:
            for ln, line in enumerate(fh, 1):
                for m in ARTIFACT_RE.finditer(line):
                    name = m.group(1)
                    if find_artifact(name):
                        continue
                    if any(mk in line for mk in RETRACTION_MARKERS):
                        continue
                    failures.append(
                        f"{rel}:{ln}: claims artifact {name!r} which does "
                        f"not exist in the tree"
                    )

    if failures:
        print(f"CLAIMS CHECK FAILED ({len(failures)}):")
        for f in failures:
            print(f"  {f}")
        return 1
    print("claims check: all published artifact references resolve")
    return 0


if __name__ == "__main__":
    sys.exit(main())
