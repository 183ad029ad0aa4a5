"""Every kernel's registers, spill and static shared memory as ``nvcc -Xptxas
-v`` reports them, for the package in this checkout or in another one, and
the difference between two such reports.

Usage (on a machine with ``nvcc``; the build is the package's own,
``ops/cuda/_build.py``)::

    python acids_transforms_tpu_torch/tools/kernel_resources.py [--root DIR] [--out FILE]
    python acids_transforms_tpu_torch/tools/kernel_resources.py --compare OLD.json NEW.json

``--root`` builds the ``acids_transforms_tpu_torch`` package found under
``DIR`` (default: the checkout holding this file), so an older tree unpacked
with ``git archive`` is measured by the same script.  ``--compare`` matches
the kernels of two reports by name; a kernel of the newer report that the
older lacks but that differs from one of its kernels only by a last template
argument ``false`` (a feature added as a template switch, off in every
instance that existed before) is read as that kernel.  It lists every kernel
whose figures moved, every new one and every one gone.
"""
from __future__ import annotations

import argparse
import importlib
import json
import re
import sys
from pathlib import Path
from typing import Dict

_SMEM = re.compile(r"Used \d+ registers.*?(\d+) bytes smem")
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
#: a last template argument ``false`` of a mangled function template in a
#: namespace: ``...ILb0ELb1ELb0EEEv...`` -> ``...ILb0ELb1EEEv...``
_LAST_FALSE = re.compile(r"Lb0E(EE?v)")


def report(root: Path) -> Dict[str, dict]:
    """Build the package under ``root`` and return its kernels' figures."""
    sys.path.insert(0, str(root))
    build = importlib.import_module("acids_transforms_tpu_torch.ops.cuda._build")
    build.load_library()
    out = {k: dict(v) for k, v in build.kernel_resources().items()}
    name = None
    for line in build.build_log().splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            continue
        m = _SMEM.search(line)
        if m and name in out:
            out[name]["smem_bytes"] = int(m.group(1))
    return out


def earlier_name(name: str, old: Dict[str, dict]) -> str:
    """``name``, or the kernel of ``old`` it was before it gained a last
    template argument ``false``."""
    if name in old:
        return name
    stripped = _LAST_FALSE.sub(r"\1", name, count=1)
    return stripped if stripped in old else name


def compare(old: Dict[str, dict], new: Dict[str, dict]) -> dict:
    """``{"same", "moved", "new", "gone"}`` between two reports."""
    new_c = {earlier_name(k, old): v for k, v in new.items()}
    moved = {k: (old[k], v) for k, v in new_c.items() if k in old and old[k] != v}
    return {"same": sum(1 for k, v in new_c.items() if old.get(k) == v), "moved": moved,
            "new": sorted(k for k in new_c if k not in old), "gone": sorted(k for k in old if k not in new_c)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"), default=None)
    args = ap.parse_args(argv)
    if args.compare:
        old, new = (json.loads(Path(p).read_text()) for p in args.compare)
        diff = compare(old, new)
        print("%d kernels unchanged, %d moved, %d new, %d gone" % (
            diff["same"], len(diff["moved"]), len(diff["new"]), len(diff["gone"])))
        for k, (a, b) in diff["moved"].items():
            print("  moved %s: %s -> %s" % (k, a, b))
        for k in diff["new"]:
            print("  new %s: %s" % (k, new.get(k, "")))
        for k in diff["gone"]:
            print("  gone %s" % k)
        return 0
    res = report(Path(args.root))
    text = json.dumps(res, indent=1, sort_keys=True)
    if args.out:
        Path(args.out).write_text(text)
    print("%d kernels built under %s" % (len(res), args.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
