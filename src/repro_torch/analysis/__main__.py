"""``python -m repro_torch.analysis`` — run streamcheck from the command line.

With no arguments, checks every registered Table-I network
(``repro_torch.apps.streams.NETWORKS``).  Positional arguments are example/script
``.py`` files: each is scanned (statically — examples are ``__main__``-
guarded scripts, importing them finds no networks) for references to
registered network names, and the referenced networks are checked.  Exits
nonzero when any network has error-severity findings; ``-v`` also prints
warnings and the repetition vector.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.apps.streams import NETWORKS
from repro_torch.ir.passes import lower


def _names_from_file(path: Path) -> List[str]:
    text = path.read_text(errors="replace")
    return [name for name in NETWORKS if name in text]


def _check_one(name: str, verbose: bool) -> Tuple[int, int]:
    net, _outputs = NETWORKS[name]()
    module = lower(net.graph(), check="warn")
    diags = module.meta["diagnostics"]
    errs, warns = diags.errors, diags.warnings
    status = "FAIL" if errs else "ok"
    print(f"{name:12s} {status}  ({len(errs)} error(s), "
          f"{len(warns)} warning(s))")
    for d in errs:
        print(f"  {d}")
    if verbose:
        for d in warns:
            print(f"  {d}")
        rep = module.meta.get("repetition", {})
        if rep:
            vec = ", ".join(f"{a}={q}" for a, q in sorted(rep.items()))
            print(f"  repetition: {vec}")
    return len(errs), len(warns)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="streamcheck: compile-time dataflow verification",
    )
    ap.add_argument(
        "files", nargs="*", type=Path,
        help="example .py files; referenced registered networks are checked "
             "(default: every registered network)",
    )
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print warnings and repetition vectors")
    args = ap.parse_args(argv)

    if args.files:
        picked: Dict[str, None] = {}
        for f in args.files:
            if not f.exists():
                print(f"error: no such file {f}", file=sys.stderr)
                return 2
            found = _names_from_file(f)
            for n in found:
                picked[n] = None
            label = ", ".join(found) if found else "no registered networks"
            print(f"{f}: {label}")
        names = list(picked)
    else:
        names = list(NETWORKS)

    total_errs = 0
    for name in names:
        errs, _warns = _check_one(name, args.verbose)
        total_errs += errs
    print(f"streamcheck: {len(names)} network(s), {total_errs} error(s)")
    return 1 if total_errs else 0


if __name__ == "__main__":
    sys.exit(main())
