"""Lane sharding over devices (flo_tpu's ``parallel`` package, without JAX)."""

from .pipeline import (  # noqa: F401
    Mesh,
    active_mesh,
    decode_step,
    device_mesh,
    encode_select_step,
    mesh_size,
    pad_batch,
    put_batch,
    put_replicated,
    shard_batch,
    split_batch,
    use_mesh,
)
