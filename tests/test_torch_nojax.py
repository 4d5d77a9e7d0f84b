"""flo_torch must import and run where JAX does not exist (the card's host
has no JAX), and must never import the reference package or JAX."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "flo_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]

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


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "flo_tpu")]
    assert not bad, f"{path.name} imports {bad}"
    assert "import_module" not in path.read_text()
