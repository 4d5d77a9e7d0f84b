"""Entry points: one search and lossy block step, and a multi-device dry run.

The twin of the repository's ``__graft_entry__.py`` for the port.

- :func:`entry` returns ``(fn, args)``: the lossless candidate search
  (``ops/select.encode_select_best``; the ``lossless_select`` kernel on the
  card) and the lossy MDCT -> SMR -> quantize step
  (``lossy/encoder._encode_blocks``; the ``temporal_mask`` kernel on the
  card) on small example inputs on ``device``.
- :func:`dryrun_multichip` shards lanes over a mesh of ``n`` devices
  (``parallel/pipeline.py``: data parallelism over codec lanes, no
  collectives), runs the search and decode steps sharded, and holds the
  bulk pipelines' sharded results to the unsharded ones: lossless bytes and
  samples equal, lossy decodes within 1.5 i16 steps.

Run ``python -m flo_torch.graft_entry [n]`` (default: every CUDA device).
"""

from __future__ import annotations

import numpy as np
import torch


def _example_lossless_inputs(L: int, S: int):
    """Seeded lanes [L, S] and seven candidates (raw, fixed 0-4, one LPC of
    order 8) for the search, as numpy."""
    from .ops import lpc

    rng = np.random.default_rng(0)
    lanes = (
        (2000 * np.sin(np.arange(L * S).reshape(L, S) * 0.01))
        + rng.integers(-50, 50, (L, S))
    ).astype(np.int32)
    nvalid = np.full(L, S, dtype=np.int32)

    kinds = ["raw", "fixed0", "fixed1", "fixed2", "fixed3", "fixed4", "lpc8"]
    NC = len(kinds)
    coeffs = np.zeros((L, NC, lpc.MAX_ORDER), dtype=np.int32)
    shifts = np.zeros((L, NC), dtype=np.int32)
    orders = np.zeros((L, NC), dtype=np.int32)
    fixed = np.zeros((L, NC), dtype=bool)
    ok = np.ones((L, NC), dtype=bool)
    for ci in range(1, 6):
        o = ci - 1
        coeffs[:, ci] = lpc._FIXED_COEFFS[o]
        orders[:, ci] = o
        fixed[:, ci] = True
    coeffs[:, 6, :8] = np.array([120, -60, 30, -15, 8, -4, 2, -1]) * 256
    shifts[:, 6] = 8
    orders[:, 6] = 8
    is_lpc = tuple(k.startswith("lpc") for k in kinds)
    return lanes, nvalid, coeffs, shifts, orders, fixed, ok, is_lpc


def _example_blocks(lanes: int) -> np.ndarray:
    """[lanes, 4, 2048] float32 blocks of a slow sine."""
    return (np.sin(np.arange(lanes * 4 * 2048).reshape(lanes, 4, 2048) * 0.003) * 0.5).astype(
        np.float32
    )


def entry(device="cuda"):
    """(fn, example_args): ``fn(*args)`` -> (residuals [8, 2048], size [8],
    q [2, 4, 1024] int16, sf [2, 4, 25] float32), on ``device``."""
    from .lib import require_device
    from .lossy.encoder import _encode_blocks
    from .parallel.pipeline import encode_select_step

    dev = require_device(device)
    L, S = 8, 2048
    lanes, nvalid, coeffs, shifts, orders, fixed, ok, is_lpc = _example_lossless_inputs(L, S)

    def fn(lanes, nvalid, coeffs, shifts, orders, fixed, ok, blocks):
        sel, k, size, residuals, win_c, win_s = encode_select_step(
            lanes, nvalid, coeffs, shifts, orders, fixed, ok, is_lpc
        )
        q, sf = _encode_blocks(blocks, 44100, -30.0)
        return residuals, size, q, sf

    args = tuple(
        torch.from_numpy(a).to(dev)
        for a in (lanes, nvalid, coeffs, shifts, orders, fixed, ok, _example_blocks(2))
    )
    return fn, args


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the sharded steps and the bulk pipelines over a mesh of
    ``n_devices`` (``devices``, default every CUDA device; they may repeat)
    and check them; raises on any mismatch, and where there are fewer than
    ``n_devices`` devices."""
    from .container import reader
    from .core.convert import i32_to_f32
    from .lossless import decoder as lld
    from .lossless import encoder as lle
    from .lossy import decoder as lod
    from .lossy import encoder as loe
    from .ops import lpc
    from .parallel import pipeline as pp

    mesh = pp.device_mesh(devices, n_devices)
    if mesh.size != n_devices:
        raise AssertionError("multichip dryrun: the mesh does not span n_devices")
    dev = mesh.devices[0]  # where the unsharded runs go

    L, S = 4 * n_devices, 512  # lanes divisible by the mesh
    lanes, nvalid, coeffs, shifts, orders, fixed, ok, is_lpc = _example_lossless_inputs(L, S)
    outs = [
        pp.encode_select_step(*shard, is_lpc)
        for shard in zip(*pp.shard_batch(mesh, lanes, nvalid, coeffs, shifts, orders, fixed, ok))
    ]
    sel, _, size, rows = (np.concatenate([o[i].cpu().numpy() for o in outs]) for i in range(4))
    if not (size < 2 * S).all():
        raise AssertionError("multichip dryrun: a lane of the example chose raw")

    # The decode step over the same mesh: stereo (mid/side off) and mono.
    take = lambda t: np.take_along_axis(t, sel.reshape(-1, *[1] * (t.ndim - 1)), 1)[:, 0]  # noqa: E731
    win = (rows, take(coeffs), take(shifts), take(orders), take(fixed))
    lane_shards = pp.shard_batch(mesh, *win, unit=2)
    stereo = pp.decode_step(*lane_shards, pp.put_batch(np.zeros(L // 2, bool), mesh), 2)
    mono = pp.decode_step(*pp.shard_batch(mesh, *win), pp.put_batch(np.zeros(L, bool), mesh), 1)
    want = i32_to_f32(torch.from_numpy(lanes)).numpy()
    if not np.array_equal(np.concatenate([m.cpu().numpy() for m in mono])[..., 0], want):
        raise AssertionError("multichip dryrun: sharded decode step mismatch")
    got = np.concatenate([s.cpu().numpy() for s in stereo]).transpose(0, 2, 1).reshape(L, S)
    if not np.array_equal(got, want):
        raise AssertionError("multichip dryrun: sharded stereo decode step mismatch")
    # Reconstruction inverts the residual computation lane for lane.
    rec = [lpc.reconstruct_best(*shard).cpu().numpy() for shard in zip(*lane_shards)]
    if not np.array_equal(np.concatenate(rec), lanes):
        raise AssertionError("multichip dryrun: reconstruction mismatch")

    # The lossy block step sharded over the channel-lane axis.
    for q, sf in (loe._encode_blocks(b, 44100, -30.0)
                  for b in pp.put_batch(_example_blocks(2 * n_devices), mesh)):
        if q.shape != (2, 4, 1024) or q.dtype != torch.int16 or not bool(sf.isfinite().all()):
            raise AssertionError("multichip dryrun: lossy block step output")

    # The bulk pipelines under the mesh against the unsharded path: bytes
    # for the integer lossless path, 1.5 i16 steps for the float32 lossy one.
    rng = np.random.default_rng(5)
    rate, C = 800, 2
    clips = [
        (0.3 * np.sin(np.arange(n * C) * 0.01)
         + 0.01 * rng.standard_normal(n * C)).astype(np.float32)
        for n in (2400, 1700, 2000)
    ]
    for analysis in ("exact", "device"):
        ref = lle.encode_many(clips, rate, C, 16, 5, analysis=analysis, device=dev)
        with pp.use_mesh(mesh):
            shd = lle.encode_many(clips, rate, C, 16, 5, analysis=analysis)
        if shd != ref:
            raise AssertionError(f"bulk lossless encode sharded mismatch ({analysis})")
    ref_dec = lld.decode_many([reader.read(d) for d in ref], device=dev)
    shd_dec = lld.decode_many([reader.read(d) for d in ref], mesh=mesh)
    for a, b, src in zip(shd_dec, ref_dec, clips):
        if not np.array_equal(a, b):
            raise AssertionError("bulk lossless decode sharded mismatch")
        if np.abs(a - src).max() > 1 / 32768 + 1e-6:
            raise AssertionError("bulk lossless round-trip out of tolerance")

    lrate = 8000  # realistic psychoacoustic band edges for the 2048-point MDCT
    lref = loe.encode_many(clips, lrate, C, 0.55, transport_dtype="packed", device=dev)
    with pp.use_mesh(mesh):
        lshd = loe.encode_many(clips, lrate, C, 0.55, transport_dtype="packed")
    lref_out = lod.decode_many([reader.read(d) for d in lref], device=dev)
    lshd_out = lod.decode_many([reader.read(d) for d in lshd], mesh=mesh)
    step = 1.0 / 32767.0
    for a, b in zip(lshd_out, lref_out):
        if a.shape != b.shape or np.abs(a - b).max() > 1.5 * step:
            raise AssertionError("bulk lossy pipeline sharded mismatch")


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) OK")
