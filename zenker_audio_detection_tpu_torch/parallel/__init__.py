from .mesh import (  # noqa: F401
    data_mesh,
    shard_batch,
    replicate,
    pad_to_multiple,
)
