"""Benchmark of flo_torch, the PyTorch and CUDA port, on one cell.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell comes from ``BENCHMARK.json``; its
configuration and traffic from ``benchmark/configs`` and ``benchmark/traffic``
(see ``harness.py``). Before ``torch`` is imported, the host's thread teams
(OpenMP, BLAS, PyTorch's) are set to the configuration's ``host_threads``,
the process is pinned to as many CPUs of its affinity mask (the last ones),
and the kernel caches are pointed at fixed directories inside the checkout.
Without a CUDA card, or with fewer than the cell asks for, the run fails and
prints no result. The last line of standard output is the result, one JSON
object; the last lines of standard error are the numbers compared for
``correct``, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "flo_tpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((REPO / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())

    threads = str(cfg["host_threads"])
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = threads
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[-cfg["host_threads"]:])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    sys.path.insert(0, str(REPO))

    import torch

    torch.set_num_threads(cfg["host_threads"])
    print(f"[setup] torch {torch.__version__} imported, {time.perf_counter() - T_START:.2f} s "
          f"since start; CPUs {sorted(os.sched_getaffinity(0))} of {len(cpus)}", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1

    from benchmark import harness

    names = {m["name"] for m in spec["end_to_end"]}
    per_layer = [m for m in spec["per_layer"]
                 if args.workload in m.get("workloads", [args.workload])] if args.trace else []
    try:
        res = harness.run_cell(args.workload, cfg, traffic, args.seed, args.seconds,
                               bool(args.trace), T_START, "cuda", per_layer)
    except harness.SetupError as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 4

    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"the process has loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"]}
    if args.trace:
        line["metrics"] = res["per_layer"]
        if "busy_s" in res:
            device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
            line["breakdown"] = res["breakdown"]
        line["launches"] = res["launches"]
    else:
        line["metrics"] = {k: v for k, v in res["metrics"].items() if k in names}
    line["device"] = device
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
