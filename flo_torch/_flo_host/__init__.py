"""Alias package over the reference package's JAX-free host modules.

``flo_torch._flo_host.<x>`` loads ``flo_tpu/<x>.py`` as a submodule of this
package, so the container reader/writer, the core tables, the Rice host coder,
the C++ natives and the futures are shared with the reference without copying
them, and without running ``flo_tpu/__init__.py`` (which imports the JAX
facade). Only JAX-free modules may be imported through it: ``container``,
``core.{constants,types,convert,crc32,rice_host,metadata,analysis,
analysis_batch,ebu_r128,blake3}``, ``native`` and ``futures``.
"""

import pathlib

__path__ = [str(pathlib.Path(__file__).resolve().parents[2] / "flo_tpu")]
