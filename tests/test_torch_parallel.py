"""flo_torch's lane sharding (``parallel/``, ``graft_entry``) on the CPU.

The cases of ``tests/test_parallel.py`` over a mesh of 4 copies of
``"cpu"`` (a device may repeat: each shard still gets buffers of its own),
plus batches whose frame count is not a mesh multiple. Held: lossless bytes
and decodes sharded equal to unsharded in both analysis modes (and
``analysis="exact"`` equal to flo_tpu's bytes), lossy decodes within 1.5 i16
steps (the reference's tolerance; equal here), the sharded search and
decode steps equal to the unsharded ones and to flo_tpu's, and
``graft_entry.entry()``'s residuals and sizes equal to
``__graft_entry__.entry()``'s, its ``q`` within the lossy tolerance of
``tests/test_torch_lossy.py``.
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from flo_torch import graft_entry
from flo_torch.container import reader
from flo_torch.lossless import decoder as lld
from flo_torch.lossless import encoder as lle
from flo_torch.lossy import decoder as lod
from flo_torch.lossy import encoder as loe
from flo_torch.ops import cuda_lpc, cuda_psycho, cuda_ricepack, cuda_select, lpc, mdct, psycho
from flo_torch.parallel import pipeline
from flo_tpu.lossless import encoder as tpu_lle
from flo_tpu.ops import lpc as tpu_lpc
from flo_tpu.ops import mdct as tpu_mdct
from flo_tpu.parallel import pipeline as tpu_pipeline

STEP = 1.0 / 32767.0
N = 4


@pytest.fixture(scope="module")
def mesh():
    return pipeline.device_mesh(["cpu"] * N)


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    yield
    assert cuda_lpc.LAUNCHES == cuda_select.LAUNCHES == cuda_ricepack.LAUNCHES == 0
    assert cuda_psycho.LAUNCHES == 0


def _graft_reference():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import __graft_entry__

    return __graft_entry__


def _clips(rng, lengths, C, rate_step=0.01):
    return [
        (0.3 * np.sin(np.arange(n * C) * rate_step)
         + 0.01 * rng.standard_normal(n * C)).astype(np.float32)
        for n in lengths
    ]


def test_mesh_spans_devices(mesh):
    assert mesh.size == N and mesh.devices == (torch.device("cpu"),) * N
    assert pipeline.device_mesh(["cpu"] * 6, n=N) == mesh
    with pytest.raises(RuntimeError):
        pipeline.device_mesh(["cpu"] * 2, n=N)
    with pytest.raises(ValueError):
        pipeline.Mesh(())
    assert set(tpu_pipeline.__all__) - set(pipeline.__all__) == {
        "batch_sharding", "bucket_count", "shape_buckets_on", "use_shape_buckets"}


def test_device_mesh_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.device_mesh()


def test_use_mesh_and_padding(mesh):
    assert pipeline.active_mesh() is None and pipeline.mesh_size(None) == 1
    other = pipeline.device_mesh(["cpu"] * 2)
    with pipeline.use_mesh(mesh):
        assert pipeline.active_mesh() is mesh and pipeline.active_mesh(other) is other
        with pipeline.use_mesh(other):
            assert pipeline.active_mesh() is other
        assert pipeline.active_mesh() is mesh
    assert pipeline.active_mesh() is None
    assert [pipeline.pad_batch(n, mesh) for n in (0, 1, 4, 5, 9)] == [0, 4, 4, 8, 12]
    x = np.arange(10 * 3).reshape(10, 3)
    shards = pipeline.split_batch(x, mesh, unit=2)  # 5 frames of 2 lanes -> 8 frames
    assert [s.shape for s in shards] == [(4, 3)] * N
    assert np.array_equal(np.concatenate(shards)[:10], x) and not np.concatenate(shards)[10:].any()


def test_shards_do_not_alias_on_a_repeated_device(mesh):
    x = np.arange(8, dtype=np.int32)
    shards, copies = pipeline.put_batch(x, mesh), pipeline.put_replicated(x, mesh)
    for t in shards + copies:
        t.add_(100)
    assert np.array_equal(x, np.arange(8))
    assert len({t.data_ptr() for t in shards + copies}) == 2 * N
    assert all(torch.equal(c, torch.from_numpy(x) + 100) for c in copies)


def test_encode_select_sharded_matches_single(mesh):
    g = _graft_reference()
    L, S = 4 * N, 512
    ours = graft_entry._example_lossless_inputs(L, S)
    theirs = g._example_lossless_inputs(L, S)
    for a, b in zip(ours, theirs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    *arrays, is_lpc = ours
    ref = tpu_pipeline.encode_select_step(*arrays, is_lpc)
    out = [pipeline.encode_select_step(*shard, is_lpc)
           for shard in zip(*pipeline.shard_batch(mesh, *arrays))]
    for i, r in enumerate(ref):
        got = np.concatenate([o[i].numpy() for o in out])
        np.testing.assert_array_equal(got, np.asarray(r))


def test_dryrun_multichip():
    graft_entry.dryrun_multichip(N, devices=["cpu"] * N)
    graft_entry.dryrun_multichip(1, devices=["cpu"])


def test_entry_matches_reference():
    fn, args = graft_entry.entry(device="cpu")
    residuals, size, q, sf = fn(*args)
    assert residuals.shape == (8, 2048) and q.shape == (2, 4, 1024) and sf.shape == (2, 4, 25)
    ref_fn, ref_args = _graft_reference().entry()
    ref = [np.asarray(a) for a in jax.jit(ref_fn)(*ref_args)]
    np.testing.assert_array_equal(residuals.numpy(), ref[0])
    np.testing.assert_array_equal(size.numpy(), ref[1])

    # The lossy step. Quantization of the same (the reference's) MDCT
    # coefficients: test_torch_lossy.py's tolerance.
    blocks = args[-1]
    ref_coeffs = np.asarray(tpu_mdct.forward(blocks.numpy()))
    same_q, _ = loe._quantize_coeffs(torch.from_numpy(ref_coeffs.copy()), 44100, -30.0)
    diff = same_q.numpy().astype(np.int64) - ref[2]
    differs = diff != 0
    assert differs.mean() <= 1e-3
    gate_flip = differs & ((same_q.numpy() == 0) | (ref[2] == 0))
    assert (np.abs(diff)[differs & ~gate_flip] == 1).all()
    assert (ref[2] != 0).any()
    # The whole step: the MDCTs agree to float32 rounding of the largest
    # coefficient, and a band's scale factor (30000 / the band's largest
    # coefficient, large in a quiet band of this pure tone) carries that
    # difference into q: |dq| <= |dc| * sf + 1, no gate flip.
    coeffs = mdct.forward(blocks, loe.BLOCK, loe.WINDOW).numpy()
    dc = np.abs(coeffs - ref_coeffs)
    assert dc.max() <= 1e-6 * np.abs(ref_coeffs).max()
    sf_bin = sf.numpy()[..., psycho.tables_to_device(44100, loe.BLOCK, "cpu")[1].numpy()]
    dq = np.abs(q.numpy().astype(np.int64) - ref[2])
    assert (dq <= np.floor(dc * sf_bin) + 1).all()
    assert not ((q.numpy() == 0) != (ref[2] == 0)).any()


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


@pytest.mark.parametrize("lengths,C,rate", [
    ((2000, 1700, 2400), 2, 800),  # 9 frames: chunks of 5 and 4, padded to 8 and 4
    ((801,), 1, 800),  # 2 frames, 2 of padding
    ((1, 13, 4000), 2, 1000),  # a 1-sample file beside short ones; 6 frames
], ids=["stereo-9-frames", "mono-2-frames", "tiny-files"])
def test_bulk_lossless_pipeline_sharded_bytes_equal(mesh, lengths, C, rate):
    clips = _clips(np.random.default_rng(7), lengths, C)
    exact = lle.encode_many(clips, rate, C, 16, 5, analysis="exact", mesh=mesh)
    for analysis in ("exact", "device"):
        ref = lle.encode_many(clips, rate, C, 16, 5, analysis=analysis, device="cpu")
        with pipeline.use_mesh(mesh):  # a mesh overrides device=
            got = lle.encode_many(clips, rate, C, 16, 5, analysis=analysis, device="cuda")
        assert got == ref, analysis
    assert exact == lle.encode_many(clips, rate, C, 16, 5, analysis="exact", device="cpu")
    if C == 2 and lengths != (1, 13, 4000):  # the reference asserts on that batch (ROADMAP.md 3)
        assert exact == tpu_lle.encode_many(clips, rate, C, 16, 5, analysis="exact")

    flos = [reader.read(d) for d in ref]
    ref_dec = lld.decode_many(flos, device="cpu")
    got_dec = lld.decode_many(flos, mesh=mesh)
    for a, b, src in zip(got_dec, ref_dec, clips):
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - src).max(initial=0) <= 1 / 32768 + 1e-6


@pytest.mark.parametrize("transport", [np.float32, "packed"], ids=["float32", "packed"])
def test_bulk_lossy_pipeline_sharded_equivalent(mesh, transport):
    rate, C = 8000, 2
    clips = _clips(np.random.default_rng(8), (4000, 3000, 5000, 2500, 4500), C, 0.02)
    ref = loe.encode_many(clips, rate, C, 0.55, transport_dtype=transport, device="cpu")
    with pipeline.use_mesh(mesh):
        got = loe.encode_many(clips, rate, C, 0.55, transport_dtype=transport)
    ref_out = lod.decode_many([reader.read(d) for d in ref], device="cpu")
    for outs in (lod.decode_many([reader.read(d) for d in got], device="cpu"),
                 lod.decode_many([reader.read(d) for d in ref], mesh=mesh)):
        for a, b in zip(outs, ref_out):
            assert a.shape == b.shape
            d = np.abs(a - b)
            assert d.max() <= 1.5 * STEP
            assert np.count_nonzero(d) <= max(8, a.size // 1000)


def test_decode_step_bit_exact(mesh):
    rng = np.random.default_rng(3)
    F, C, S = 2 * N, 2, 300
    rows = rng.integers(-100, 100, (F * C, S)).astype(np.int32)
    coeffs = np.zeros((F * C, lpc.MAX_ORDER), np.int32)
    coeffs[:, 0] = 1 << 10
    shifts = np.full(F * C, 10, np.int32)
    orders = np.ones(F * C, np.int32)
    fixed = np.zeros(F * C, bool)
    fixed[::3], orders[::3] = True, 2
    coeffs[::3] = lpc._FIXED_COEFFS[2]
    mid_side = rng.integers(0, 2, F).astype(bool)
    lanes = (rows, coeffs, shifts, orders, fixed)
    shards = pipeline.decode_step(*pipeline.shard_batch(mesh, *lanes, unit=C),
                                  pipeline.put_batch(mid_side, mesh), C)
    got = np.concatenate([s.numpy() for s in shards])
    want = lld._device_decode(*(torch.from_numpy(a) for a in (*lanes, mid_side)), channels=C)
    np.testing.assert_array_equal(got, want.numpy())
    ref = tpu_pipeline.decode_step(*lanes, mid_side, C)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_sharded_reconstruction_bit_exact(mesh):
    rng = np.random.default_rng(0)
    L, S = 2 * N, 300
    residuals = rng.integers(-100, 100, (L, S)).astype(np.int32)
    coeffs = np.zeros((L, lpc.MAX_ORDER), np.int32)
    coeffs[:, 0] = 1 << 10
    shifts = np.full(L, 10, np.int32)
    orders = np.ones(L, np.int32)
    fixed = np.zeros(L, bool)
    args = (residuals, coeffs, shifts, orders, fixed)
    ref = np.asarray(tpu_lpc.reconstruct(*args))
    out = np.concatenate([lpc.reconstruct_best(*shard).numpy()
                          for shard in zip(*pipeline.shard_batch(mesh, *args))])
    np.testing.assert_array_equal(out, ref)
