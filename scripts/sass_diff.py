#!/usr/bin/env python3
"""Compare the SASS of the kernels of one CUDA source in two checkouts.

    python3 scripts/sass_diff.py OTHER_ROOT STEM [NAME ...]

Builds ``csrc/<STEM>.cu`` of OTHER_ROOT and of this checkout, each with
its own ``repro_torch.kernels.build`` (in a process of its own),
disassembles both libraries with ``cuobjdump -sass`` and prints one JSON
line: for each kernel whose mangled name holds one of the NAMEs (every
kernel when none is given), whether its SASS is the same in both, its
instruction count in each, and how many instruction lines differ in
place, with the first such pair. A change that must leave some kernels as they
were (a shared helper made generic, launch code edited) is checked so.
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); exits non-zero without
it or when a kernel is missing from either library.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def build(root: Path, stem: str) -> Path:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "print(build.compile_source(sys.argv[2]))")
    out = subprocess.run([sys.executable, "-c", code, str(root / "src"), stem],
                         capture_output=True, text=True, check=True).stdout
    return Path(out.strip().splitlines()[-1])


def stable(name: str) -> str:
    """A mangled name with its anonymous namespace (whose mangled form
    carries a hash that may change with the source) written "(anon)"."""
    m = re.match(r"_ZN(\d+)", name)
    if m and name[m.end():].startswith("_GLOBAL__N_"):
        return "_ZN(anon)" + name[m.end() + int(m.group(1)):]
    return name


def kernels(lib: Path, cuobjdump: str) -> dict:
    """{stable name: [instruction lines]} of a library's SASS."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = stable(m.group(1))
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[name].append(line.strip())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("stem")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        sys.exit("sass_diff.py: no cuobjdump")
    a = kernels(build(args.other.resolve(), args.stem), cuobjdump)
    b = kernels(build(HERE, args.stem), cuobjdump)
    names = sorted(n for n in set(a) | set(b)
                   if not args.names or any(s in n for s in args.names))
    missing = [n for n in names if n not in a or n not in b]
    res = {}
    for n in names:
        if n in missing:
            continue
        diff = [(x, y) for x, y in zip(a[n], b[n]) if x != y]
        res[n] = {"same": a[n] == b[n], "instructions": [len(a[n]), len(b[n])],
                  "lines_differing": len(diff), "first_difference":
                  list(diff[0]) if diff else None}
    print(json.dumps({"stem": args.stem, "kernels": res,
                      "missing": missing}), flush=True)
    if missing or not names:
        sys.exit(1)


if __name__ == "__main__":
    main()
