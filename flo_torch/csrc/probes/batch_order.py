"""Does a float32 row sum on the card depend on how many rows are summed?

    python3 flo_torch/csrc/probes/batch_order.py      # on the card

For rows of S samples (S = a frame: 44,100 to 192,000) it sums the squares
of seeded int16 values as one [480, S] batch and as two [240, S] halves and
prints how many of the 480 float32 sums differ. PyTorch splits a row over
several blocks when a thread would sum 256 values or more, and how many
depends on the number of rows; that is why ``ops/lpc.autocorrelation_device``
and ``ops/select.device_analysis`` sum exactly in int64 (a sharded batch must
give the unsharded bytes). It then times the 13 lag sums of a [480, 44100]
chunk both ways, in turns, with CUDA events.
"""

import subprocess

import torch


def rows_that_differ(samples: int) -> int:
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(-(1 << 15), 1 << 15, (480, samples), device="cuda", generator=g)
    x = (x * x).to(torch.float32)
    halves = torch.cat([x[:240].sum(1), x[240:].sum(1)])
    return int((x.sum(1) != halves).sum())


def lag_sums(x, dtype):
    y = x.to(dtype)
    S = y.shape[1]
    return [(y[:, lag:] * y[:, : S - lag]).sum(1) for lag in range(13)]


def time_ms(fn, iters: int = 10) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for S in (44100, 96000, 131072, 192000):
        print(f"[batch order] S = {S}: {rows_that_differ(S)} of 480 float32 row sums differ "
              f"between the batch and its halves [{gpu}]")
    x = torch.randint(-(1 << 15), 1 << 15, (480, 44100), device="cuda", dtype=torch.int32)
    times = {"float32": [], "int64": []}
    for dtype in (torch.float32, torch.int64, torch.int64, torch.float32):
        times[str(dtype).split(".")[1]].append(time_ms(lambda: lag_sums(x, dtype)))
    print(f"[batch order] 13 lag sums of [480, 44100]: float32 {times['float32']} ms, "
          f"int64 (exact) {times['int64']} ms [{gpu}]")


if __name__ == "__main__":
    main()
