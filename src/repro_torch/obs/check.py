"""CLI gate over exported Perfetto timelines (the CI smoke step):

    python -m repro_torch.obs.check experiments/trace_*.json \
        --kinds refresh,cached,pipelined

Parses each file, validates it against the ``trace_event`` schema subset
(:func:`repro_torch.obs.export.validate_chrome_trace`) and asserts >0
spans per required step kind; exits non-zero on any violation.
"""
from __future__ import annotations

import argparse
import json
import sys

from .export import validate_chrome_trace


def check_file(path: str, kinds: list[str]) -> dict:
    with open(path) as f:
        payload = json.load(f)
    stats = validate_chrome_trace(payload)
    missing = [k for k in kinds
               if stats["spans_by_cat"].get(k, 0) <= 0]
    if missing:
        raise ValueError(f"{path}: no spans for step kind(s) {missing}; "
                         f"have {stats['spans_by_cat']}")
    if stats["n_spans"] <= 0:
        raise ValueError(f"{path}: trace contains no spans")
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="trace_*.json paths")
    ap.add_argument("--kinds", default="",
                    help="comma-separated step kinds that must each have "
                         ">0 spans (e.g. refresh,cached,pipelined)")
    args = ap.parse_args(argv)
    kinds = [k for k in args.kinds.split(",") if k]
    ok = True
    for path in args.files:
        try:
            stats = check_file(path, kinds)
            print(f"OK {path}: {json.dumps(stats)}")
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"FAIL {e}", file=sys.stderr)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
