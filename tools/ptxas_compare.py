#!/usr/bin/env python3
"""Compares the ptxas lines of two checkouts' kernel builds.

    python3 tools/ptxas_compare.py <parent checkout> <checkout>

Reads the compiler reports that ops/_cuda.py keeps beside each library
(build/torch_kernels/<source>_<hash>.so.log, `nvcc -Xptxas -v`) in both
checkouts, after chip_smoke.py or any other run has built them, and prints
one line per kernel instance: its source, "same", "CHANGED", "GONE" (only in
the first) or "NEW" (only in the second), its mangled name and its
registers, shared memory (bytes) and spill stores (bytes), first checkout
then second. Names lose the anonymous namespace's part, which hashes the
file. Exits 0; reading the lines is the check.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
USED = re.compile(r"Used (\d+) registers")
SMEM = re.compile(r"(\d+) bytes smem")
SPILL = re.compile(r"(\d+) bytes spill stores")
# the anonymous namespace's part of a mangled name, which hashes the file
ANON = re.compile(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}")


def instances(checkout: Path) -> dict:
    """(source, mangled name) -> (registers, shared memory, spill stores) of
    every instance in the checkout's build reports."""
    found = {}
    for log in sorted((checkout / "build" / "torch_kernels").glob("*.so.log")):
        source = log.name.rsplit("_", 1)[0]
        name, seen = None, {}
        for line in log.read_text().splitlines():
            entry = ENTRY.search(line)
            if entry:
                name, seen = ANON.sub("", entry.group(1)), {}
                found[(source, name)] = (None, None, None)
                continue
            for key, pattern in (("regs", USED), ("smem", SMEM),
                                 ("spill", SPILL)):
                match = pattern.search(line)
                if name and match:
                    seen[key] = int(match.group(1))
            if name:
                found[(source, name)] = (seen.get("regs"), seen.get("smem", 0),
                                         seen.get("spill"))
    return found


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    first, second = (instances(Path(p)) for p in sys.argv[1:])
    for key in sorted(set(first) | set(second)):
        a, b = first.get(key), second.get(key)
        state = ("GONE" if b is None else "NEW" if a is None
                 else "same" if a == b else "CHANGED")
        print(f"{key[0]:20s} {state:7s} {key[1]}  {a} -> {b}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
