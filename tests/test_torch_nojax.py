"""flo_torch must import and run where JAX does not exist (the card's host
has no JAX), and must never import the reference package or JAX."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "flo_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                            REPO / "bench_torch.py"]

_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import numpy as np
    import flo_torch
    from flo_torch.ops import cuda_lpc

    rate = 8000
    t = np.arange(2 * rate + 123) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t), 0.2 * np.cos(2 * np.pi * 97 * t)], 1)
    x = x.astype(np.float32).reshape(-1)
    data = flo_torch.encode(x, rate, 2)
    y = flo_torch.decode(data, device="cpu")
    ints = np.trunc(np.clip(x * np.float32(32767), -32768, 32767)).astype(np.int32)
    assert np.array_equal(y, ints.astype(np.float32) * np.float32(1 / 32767))
    assert flo_torch.validate(data) and flo_torch.info(data).channels == 2

    from flo_torch import batch
    from flo_torch.lossless import encoder
    from flo_torch.ops import cuda_ricepack, cuda_select
    clips = [x, x[: 2 * 3000]]
    exact = encoder.encode_many(clips, rate, 2, analysis="exact", device="cpu")
    assert exact[0] == flo_torch.encode(x, rate, 2, analyze=False)
    for clip, blob in zip(clips, batch.encode_many(clips, rate, 2, device="cpu")):
        out = batch.decode_many([blob], device="cpu")[0]
        i = np.trunc(np.clip(clip * np.float32(32767), -32768, 32767)).astype(np.int32)
        assert np.array_equal(out, i.astype(np.float32) * np.float32(1 / 32767))
    assert encoder.encode(ints, rate, 2, compat="reference-bugs", device="cpu")
    assert cuda_lpc.LAUNCHES == cuda_select.LAUNCHES == cuda_ricepack.LAUNCHES == 0

    # Lossy: encode -> decode on the CPU, single file and bulk, and the
    # sparse coder built from the port's own source.
    import pathlib
    from flo_torch import native
    from flo_torch.ops import cuda_psycho
    lossy = flo_torch.encode_lossy(x, rate, 2, 4, device="cpu")
    assert flo_torch.validate(lossy) and flo_torch.info(lossy).is_lossy
    z = flo_torch.decode(lossy, device="cpu")
    assert len(z) == -(-(len(x) // 2) // 1024) * 1024 * 2
    noise = z[: len(x)] - x
    assert 10 * np.log10(np.sum(x * x) / np.sum(noise * noise)) > 30.0
    bulk = batch.encode_lossy_many(clips, rate, 2, 1, transport_dtype="packed", device="cpu")
    outs = batch.decode_many(bulk + [data], device="cpu")
    assert [len(o) for o in outs[:2]] == [len(flo_torch.decode(b, device="cpu")) for b in bulk]
    assert np.array_equal(outs[2], y)
    if native.available():
        so = native.library_path("sparse")
        assert so.is_file() and so.parent == native.BUILD_DIR
        assert pathlib.Path(native.__file__).with_name("sparse.cpp").is_file()
        assert native.sparse_decode_entries([bytes([5, 0])], 5) is not None
    assert cuda_psycho.LAUNCHES == 0

    # The rest of the public API: streaming, seeking, metadata, WAV ingest
    # and the reflo facade.
    from flo_torch import audio_io, debug, reflo, seeking
    from flo_torch.streaming import DecoderState, StreamingDecoder, StreamingEncoder
    enc = StreamingEncoder(rate, 2, device="cpu")
    for i in range(0, len(x), 4096):
        enc.push_samples(x[i : i + 4096])
    streamed = enc.finalize()
    assert flo_torch.validate(streamed)
    for blob, exact_frames in ((streamed, True), (lossy, False)):
        dec = StreamingDecoder(device="cpu")
        for i in range(0, len(blob), 1000):
            dec.feed(blob[i : i + 1000])
        got = dec.decode_available()
        want = flo_torch.decode(blob, device="cpu")
        assert dec.state == DecoderState.FINISHED and got.shape == want.shape
        if exact_frames:
            assert np.array_equal(got, y) and np.array_equal(got, want)
        else:
            assert np.abs(np.rint(got * 32767.0) - np.rint(want * 32767.0)).max() <= 1
    hit = flo_torch.seek_to_time(streamed, 1500)
    assert (hit.frame_index, hit.sample_offset) == (1, rate // 2)
    assert len(flo_torch.get_toc(streamed)) == 3 and seeking.get_toc is flo_torch.get_toc
    assert np.array_equal(flo_torch.decode_frame_at(streamed, 1, device="cpu"),
                          y[2 * rate : 4 * rate])
    assert flo_torch.decode_frame_at(lossy, 2, device="cpu").shape == (2048,)
    tagged = flo_torch.update_metadata_bytes(streamed, flo_torch.create_metadata("t", "a", "b"))
    assert flo_torch.has_metadata(tagged) and flo_torch.get_metadata(tagged).title == "t"
    assert flo_torch.strip_metadata(tagged) == streamed and flo_torch.validate(tagged)
    assert flo_torch.version() == flo_torch.info(tagged).version
    assert flo_torch.format_time_ms(61_000) == "1:01"
    wav = audio_io.write_wav_to_bytes(x, rate, 2)
    made = reflo.encode_from_audio(wav, reflo.EncodeOptions.lossless(), device="cpu")
    assert reflo.validate_flo(made) and reflo.get_metadata(made).source_format
    back, r, c, _ = audio_io.read_audio_from_bytes(reflo.decode_to_wav(made, device="cpu"))
    assert (r, c) == (rate, 2) and np.array_equal(back, y)
    made = reflo.encode_from_samples(x, rate, 2, None, reflo.EncodeOptions.lossy_quality(0.9),
                                     device="cpu")
    assert reflo.get_flo_info(made).is_lossy
    with debug.debug_mode():
        assert np.array_equal(flo_torch.decode(streamed, device="cpu"), y)

    # The CLI (encode + decode) and one service round trip, on the CPU.
    import tempfile, threading, urllib.request
    from flo_torch import cli, service
    work = pathlib.Path(tempfile.mkdtemp())
    (work / "in.wav").write_bytes(wav)
    assert cli.main(["encode", str(work / "in.wav"), str(work / "o.flo"), "--device", "cpu"]) == 0
    assert cli.main(["decode", str(work / "o.flo"), str(work / "o.wav"), "--device", "cpu"]) == 0
    assert np.array_equal(audio_io.read_audio_from_bytes((work / "o.wav").read_bytes())[0], y)
    srv = service.make_server("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}{path}", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()
    served = post(f"/v1/encode?sample_rate={rate}&channels=2", x.astype("<f4").tobytes())
    assert np.array_equal(np.frombuffer(post("/v1/decode", served), "<f4"), y)
    srv.shutdown()
    srv.server_close()
    thread.join(10)
    assert cuda_lpc.LAUNCHES == cuda_psycho.LAUNCHES == 0
    assert sys.modules["jax"] is None
    leaked = [m for m in sys.modules if m.startswith(("jax.", "jaxlib", "flo_tpu"))]
    assert not leaked, leaked
    print("NOJAX-OK")
    """
)


def test_port_runs_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout


_NO_REFERENCE_FILES = textwrap.dedent(
    """
    import pathlib
    repo = pathlib.Path(REPO)
    files = [pathlib.Path(m.__file__).resolve() for m in list(sys.modules.values())
             if getattr(m, "__file__", None)]
    assert not [f for f in files if "flo_tpu" in f.parts], "a flo_tpu file was loaded"
    assert not [f for f in files if repo in f.parents], "a file of the repository was loaded"
    maps = pathlib.Path("/proc/self/maps").read_text()
    assert "flo_tpu" not in maps and str(repo) not in maps, "a library of the repository is mapped"
    print("ALONE-OK")
    """
)


def test_port_runs_alone_without_the_reference(tmp_path):
    """A copy of flo_torch/ in a directory with no flo_tpu/, the repository
    off sys.path: the round trip and the CPU bulk encode run there, and no
    module or shared library of the reference (or of the repository) is
    loaded. The host natives already built for this checkout are copied
    along, so the copy does not compile them again."""
    shutil.copytree(REPO / "flo_torch", tmp_path / "flo_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    built = REPO / "build" / "flo_torch" / "native"
    if built.is_dir():
        shutil.copytree(built, tmp_path / "build" / "flo_torch" / "native",
                        ignore=shutil.ignore_patterns(".lock", "*.tmp"))
    script = f"REPO = {str(REPO)!r}\n" + _SCRIPT + _NO_REFERENCE_FILES
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout and "ALONE-OK" in res.stdout


def test_module_entry_runs_from_a_copy_alone(tmp_path):
    """``python -m flo_torch --help`` from a copy of flo_torch/ alone."""
    shutil.copytree(REPO / "flo_torch", tmp_path / "flo_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "flo_torch", "--help"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("usage: flo-torch") and "serve" in res.stdout


_MODULES = ["streaming", "seeking", "reflo", "audio_io", "debug", "flac", "vorbis", "mp3", "aac",
            "lib", "batch", "cli", "__main__", "service", "demo_page", "parallel.pipeline",
            "graft_entry"]


@pytest.fixture(scope="module")
def imported_with_jax_blocked():
    """One interpreter with ``jax`` blocked imports each module in turn and
    says after each whether anything of JAX or of the reference got loaded."""
    script = (
        "import contextlib, importlib, io, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['flo-torch', '--help']\n"
        f"for name in {_MODULES!r}:\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(io.StringIO()):\n"
        "            importlib.import_module('flo_torch.' + name)\n"
        "    except SystemExit as e:  # __main__ runs the CLI, and --help exits 0\n"
        "        assert name == '__main__' and e.code == 0, (name, e.code)\n"
        "    leaked = [m for m in sys.modules if m.startswith(('jax.', 'jaxlib', 'flo_tpu'))]\n"
        "    print('IMPORTED', name, leaked)\n"
    )
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("module", _MODULES)
def test_module_imports_with_jax_blocked(imported_with_jax_blocked, module):
    assert f"IMPORTED {module} []" in imported_with_jax_blocked


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _relative_imports_leave_the_port(path):
    """Relative imports of a file under flo_torch/ that climb above it."""
    depth = len(path.relative_to(REPO / "flo_torch").parts)  # packages from flo_torch down
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n.level for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level > depth]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "flo_tpu")]
    assert not bad, f"{path.name} imports {bad}"
    text = path.read_text()
    assert "import_module" not in text
    # No package of the port borrows another directory's files (an alias
    # package whose __path__ points elsewhere), and no relative import
    # climbs out of flo_torch/.
    assert "__path__" not in text
    if REPO / "flo_torch" in path.parents:
        assert not _relative_imports_leave_the_port(path)
