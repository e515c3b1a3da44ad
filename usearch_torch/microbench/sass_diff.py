"""Whether the kernels of two checkouts compile to the same SASS.

    python -m usearch_torch.microbench.sass_diff OTHER_CHECKOUT [source ...]

Builds csrc/<source>.cu (default: every source of `build.SIGNATURES`) of
this checkout and of OTHER_CHECKOUT (e.g. the parent commit, unpacked with
`git archive`) with the same nvcc flags, all nvcc processes started
together, reads each library's SASS (`cuobjdump -sass`), normalises the
names of anonymous namespaces (they carry a hash of the file) and the
padding between an instruction and its encoding, and prints
per source how many functions are the same instruction for instruction,
which differ (with their first differing lines), which only one side has
by name but the other has under another name, instruction for instruction
(`renamed`: a template argument that changed type or name), and which only
one side has. Needs nvcc and cuobjdump (the
card's machine); builds into usearch_torch/_build/sass_diff/.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from .. import build

_ANON = re.compile(r"(\d+)_GLOBAL__N__")


def normalise(text: str) -> str:
    """``text`` with each mangled anonymous namespace (its length, then
    ``_GLOBAL__N__`` and a hash of the file) replaced by ``ANON``."""
    out, pos = [], 0
    for m in _ANON.finditer(text):
        if m.start() < pos:
            continue
        out.append(text[pos : m.start()] + "ANON")
        pos = m.end(1) + int(m.group(1))
    return "".join(out) + text[pos:]


def functions(lib: Path) -> dict:
    """The library's SASS by function, names normalised."""
    exe = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(exe), "-sass", str(lib)], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    # cuobjdump pads each line to the module's widest instruction: compare
    # the text with runs of blanks collapsed
    sass = re.sub(r"[ \t]+", " ", normalise(sass))
    # the last function's block runs to the end of the dump: drop the
    # trailing blanks so it compares as any other
    return {name: body.rstrip() for name, body in (block.split("\n", 1) for block in sass.split("Function : ")[1:])}


def renamed(mine: dict, theirs: dict) -> list:
    """Pairs (name here, name in the other) of functions that only one
    side has by name and whose SASS is the same instruction for instruction;
    each function pairs at most once."""
    free = {}
    for f in sorted(theirs.keys() - mine.keys()):
        free.setdefault(theirs[f], []).append(f)
    pairs = []
    for f in sorted(mine.keys() - theirs.keys()):
        if free.get(mine[f]):
            pairs.append((f, free[mine[f]].pop(0)))
    return pairs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve() / "usearch_torch" / "csrc"
    names = argv[1:] or list(build.SIGNATURES)
    out = build.BUILD_DIR / "sass_diff"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for side, csrc in (("this", build._CSRC), ("other", other)):
        for name in names:
            lib = out / f"lib{name}-{side}.so"
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / f"{name}.cu")]
            procs[name, side] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                      text=True))
    for (name, side), (_, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {side} {name}.cu:\n{report}")
    for name in names:
        mine, theirs = functions(procs[name, "this"][0]), functions(procs[name, "other"][0])
        same = sorted(f for f in mine.keys() & theirs.keys() if mine[f] == theirs[f])
        differ = sorted(f for f in mine.keys() & theirs.keys() if mine[f] != theirs[f])
        moved = renamed(mine, theirs)
        here = sorted(mine.keys() - theirs.keys() - {a for a, _ in moved})
        there = sorted(theirs.keys() - mine.keys() - {b for _, b in moved})
        print(f"{name}.cu: {len(same)} functions the same, {len(moved)} the same under another name, "
              f"{len(differ)} differ, {len(here)} only here, {len(there)} only in the other", flush=True)
        for f in differ:
            a, b = mine[f].splitlines(), theirs[f].splitlines()
            pairs = [(x, y) for x, y in zip(a, b) if x != y]
            print(f"  differ: {f.strip()} ({len(a)} and {len(b)} lines, {len(pairs)} of the first "
                  f"{min(len(a), len(b))} differ)", flush=True)
            for x, y in pairs[:3]:
                print(f"    here:  {x.strip()[:150]}\n    other: {y.strip()[:150]}", flush=True)
        for a, b in moved:
            print(f"  renamed: {b.strip()} -> {a.strip()}", flush=True)
        for label, group in (("only here", here), ("only in the other", there)):
            for f in group:
                print(f"  {label}: {f.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
