"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 benchmark/readings.py --cells <cell> ... --seeds 12 --control-seeds 3

For each cell, in one process: on each of ``--seeds`` seeds the program's
numbers (the cell's content, each pool batch through the timed entry once,
the same tracks checked as a run checks), and on ``--control-seeds`` further
seeds the control's (the entry's ``control``: the reference in bfloat16 in
the program's place). One JSON line a reading on standard output. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    sys.path.insert(0, str(REPO))
    threads = None
    for name in args.cells:
        cfg = json.loads((REPO / "benchmark" / "configs" / f"{cells[name]['config']}.json").read_text())
        threads = threads or str(cfg["host_threads"])
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ.setdefault(var, threads)

    import torch

    from benchmark import correct, harness

    torch.set_num_threads(int(threads))
    seed = args.first_seed
    for name in args.cells:
        cfg = harness.load("configs", cells[name]["config"])
        traffic = harness.load("traffic", cells[name]["traffic"])
        ent = harness.load_entry(traffic["entry"])
        call = ent.call(cfg, traffic, "cuda")
        for kind, n in (("program", args.seeds), ("control", args.control_seeds)):
            for _ in range(n):
                t0 = time.perf_counter()
                pool = harness.make_pool(cfg, traffic, seed)
                sample = correct.sample_tracks(seed, traffic["tracks_s"], len(pool))
                tally = correct.Tally(cfg["limits"])
                if kind == "control":
                    ent.control(tally, cfg, [(key, pool[key[0]][key[1]]) for key in sample])
                else:
                    inputs = ent.prepare(cfg, traffic, pool, "cuda")
                    futs = [call(b) for b in inputs]
                    outs = [f.result() for f in futs]
                    ent.check(tally, cfg, [(key, outs[key[0]][key[1]], inputs[key[0]][key[1]],
                                            pool[key[0]][key[1]]) for key in sample])
                numbers = tally.numbers(cfg)
                print(json.dumps({"cell": name, "kind": kind, "seed": seed, "numbers": numbers,
                                  "correct": correct.verdict(numbers, cfg["limits"]),
                                  "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
                seed += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
