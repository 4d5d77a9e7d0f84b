"""What the benchmark imports: nothing of JAX, flo_tpu or the older
benchmark scripts, compared by whole top-level names; and a reference that
imports nothing of the program it judges."""

import ast
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "flo_tpu", "bench", "bench_torch", "chip_smoke"}


def imported_tops(path: pathlib.Path) -> set:
    """Top-level names (the part before the first dot) of every absolute
    import in a module."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


#: Every module the benchmark runs; the tests load the originals that the
#: frozen copies are held to, so they are not among them.
RUN_MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", RUN_MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py"))
                         + [BENCH / "correct.py", BENCH / "frozen.py", BENCH / "content.py"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & {"flo_torch", "torch"}


def test_whole_names_are_compared():
    # The port's name begins with the JAX package's: a prefix match would
    # refuse it.
    assert "flo_torch".split(".")[0] not in FORBIDDEN
    assert imported_tops(BENCH / "harness.py") >= {"flo_torch"}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_loaded_modules():
    loaded = _modules_after("import benchmark.harness, benchmark.readings")
    assert not loaded & FORBIDDEN
    loaded = _modules_after("import benchmark.correct, benchmark.frozen, benchmark.devtrace, "
                            "benchmark.content")
    assert not loaded & (FORBIDDEN | {"flo_torch", "torch"})
