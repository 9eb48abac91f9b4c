#!/usr/bin/env python3
"""Compare the error fields of two runs of ``chip_smoke.py``.

    python3 tools/compare_smoke_runs.py OLD_STDOUT NEW_STDOUT

Each file is a run's standard output: one JSON object a line, a phase's
lines named by their ``"phase"`` key.  An error field is a numeric leaf
whose key path names an error or a compared magnitude (a key holding
``err``, ``relmax``, ``max_abs`` or ``drift``), keyed by the phase, the
line's place among that phase's lines and the path (list items by
index), so a field a run adds, a new phase or a new case, is in one run
only.  Prints one JSON object: how many fields both runs have, how many
of them are equal to the last digit, each one that differs (old, new),
and how many only one run has.  Exits 1 when a shared field differs.
Reads nothing but the two files.
"""
from __future__ import annotations

import json
import sys

MARKS = ("err", "relmax", "max_abs", "drift")


def leaves(obj, path=()):
    """(path, number) of every numeric leaf under `obj`."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from leaves(v, path + (str(i),))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def error_fields(lines) -> dict:
    """{(phase, place, path): value} of a run's error fields."""
    seen, out = {}, {}
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict) or "phase" not in rec:
            continue
        phase = rec["phase"]
        place = seen[phase] = seen.get(phase, -1) + 1
        for path, value in leaves({k: v for k, v in rec.items()
                                   if k not in ("phase", "t")}):
            if any(mark in key for key in path for mark in MARKS):
                out[(phase, place, ".".join(path))] = value
    return out


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (error_fields(open(p, encoding="utf-8")) for p in argv[1:])
    shared = sorted(set(old) & set(new))
    differ = [{"field": f"{ph}[{i}].{path}", "old": old[k], "new": new[k]}
              for k in shared for ph, i, path in (k,) if old[k] != new[k]]
    print(json.dumps({"shared": len(shared),
                      "equal": len(shared) - len(differ),
                      "differ": differ, "old_only": len(set(old) - set(new)),
                      "new_only": len(set(new) - set(old))}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
