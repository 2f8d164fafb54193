"""Readings that set a cell's limits: the program's, and the control's.

    python3 -m benchmarks.control --workload <name> --seeds 1,2,3 --seconds <s> [--control 3] [--faults 3]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` (the cell's own load), then the comparison's numbers for what
the program produced; for the first ``--control`` seeds also the numbers of
the control (the reference in the precision below the configuration's, in
the program's place), and for the first ``--faults`` seeds of a training
cell those of the reference with half of each batch left out.  One JSON
line a seed; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from benchmarks import harness
from benchmarks.run import _env


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    _env()
    import torch

    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(harness.load_spec(), args.workload)
    drv = harness.driver(c["traffic"]["kind"])
    dev = torch.device("cuda", 0)
    print(f"[control] card {harness.card_record()}", file=sys.stderr)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        st = drv.setup(c, seed, dev, harness.Spans())
        res = drv.window(st, args.seconds, harness.Spans())
        drv.finish(st)
        row = dict(workload=args.workload, seed=seed, attempted=res["attempted"], program=drv.readings(st))
        if n < args.control:
            row["control"] = drv.readings(st, control=True)
        if n < args.faults and c["traffic"]["kind"] == "train":
            row["half_batch"] = drv.readings(st, fault="half_batch")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del st
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
