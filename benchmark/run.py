"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload stcn-480p.session60 --seed 1 \
        --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit (also the last lines of standard error).
Exits non-zero, printing no result, without the cards the cell needs or
when JAX or the JAX package was loaded.  ``--precision bf16`` builds the
program in bfloat16 (``bf16-autocast``: runs it under ``torch.autocast``),
the control, which has to come out not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    from benchmark.core import device as card, guard
    from benchmark.core.spec import Cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--precision", choices=("f32", "bf16", "bf16-autocast"),
                   default=None,
                   help="the control: the program's --dtype bf16, or the "
                        "program under torch.autocast to bf16")
    args = p.parse_args(argv)

    card.set_cache_dirs()
    cell = Cell.load(args.workload)
    from benchmark.core.harness import execute

    try:
        out = execute(cell, args.seed, args.seconds, bool(args.trace), T_START,
                      precision=args.precision)
    except card.NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = guard.forbidden_modules(list(sys.modules))
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
