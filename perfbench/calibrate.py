"""Readings that a cell's limits are set from (not run by the benchmark):
the program's compared numbers on many seeds, and the control's, the plain
reference one precision lower in the program's place, on a few.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --first-seed <n> [--out <file.jsonl>]

For each seed the cell's runner (``readings``) builds the program from
that seed's weights, runs as much of it as a run's check compares, and
compares it with the reference the way a run's check does; on the control
seeds it also compares the control's outputs on the same inputs, and with
``--witness`` (synthesis) the reference's in the configuration's own
bf16.  One JSON
line a seed and side.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.harness import (BENCH_DIR, cache_dirs, find_cell,  # noqa: E402
                               load_runner)


def readings(name: str, seed: int, control: bool, device: str,
             bench_dir: str = BENCH_DIR, witness: bool = False) -> list[dict]:
    """The cell runner's readings on one seed: [{cell, seed, side,
    numbers}] for the program, and the control and the bf16 witness
    where asked."""
    cell, config, traffic = find_cell(name, bench_dir)
    drv = load_runner(cell, bench_dir)
    cell = dict(cell, name=name, bench_dir=bench_dir)
    return [{"cell": name, "seed": seed, "side": side, "numbers": numbers}
            for side, numbers in drv.readings(cell, config, traffic, seed,
                                              device, control, witness)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--witness", action="store_true",
                   help="also read the reference in bf16 on every seed")
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = open(args.out, "a") if args.out else None
    for i in range(args.seeds):
        for line in readings(args.workload, args.first_seed + i,
                             i < args.control_seeds, device,
                             witness=args.witness):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
