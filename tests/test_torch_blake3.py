"""flo_torch's C++ BLAKE3 against the pure-Python spec digests, with more than
one OpenMP thread: the tree's levels are merged in parallel, and every call
must give the same 32 bytes."""

import ctypes

import numpy as np
import pytest

from flo_tpu.core import blake3 as tpu_blake3
from flo_torch import native
from flo_torch.core import blake3

THREADS = 4
CALLS = 20


@pytest.fixture
def omp_threads():
    """THREADS OpenMP threads for the calling thread's parallel regions; the
    earlier setting comes back afterwards."""
    if native.blake3_digest(b"x") is None:
        pytest.skip("no C++ toolchain: the native BLAKE3 is not built")
    omp = ctypes.CDLL("libgomp.so.1")
    before = omp.omp_get_max_threads()
    omp.omp_set_num_threads(THREADS)
    assert omp.omp_get_max_threads() == THREADS
    yield
    omp.omp_set_num_threads(before)


@pytest.mark.parametrize("size", [1, 1024, 1025, 64 * 1024 + 7, 1 << 20])
def test_native_digest_is_the_spec_digest_on_every_call(size, omp_threads):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    want = blake3.digest(data.tobytes())
    assert want == tpu_blake3.digest(data.tobytes())
    got = {native.blake3_digest(data) for _ in range(CALLS)}
    assert got == {want}
    assert native.blake3_digest(data.tobytes()) == want


def test_fingerprint_hash_is_the_spec_digest(omp_threads):
    """The analysis fingerprint hashes a 9-byte header and the float32 PCM;
    with several threads it must be the pure-Python digest of the same
    bytes."""
    from flo_torch.core import analysis

    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, 2 * 50_000).astype(np.float32)
    header = bytes([2]) + np.array([44100, x.size], "<u4").tobytes()
    want = blake3.digest(header + x.astype("<f4").tobytes())
    for _ in range(5):
        assert analysis.extract_spectral_fingerprint(x, 2, 44100).hash == want
