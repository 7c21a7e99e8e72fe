"""Block streaming: the port of celestia_app_tpu/parallel/pipeline.py.

The JAX package's multi-chip modules (mesh, sharded extend and repair) are
not ported yet (ROADMAP, queue 1)."""

from celestia_app_tpu_torch.parallel.pipeline import (  # noqa: F401
    BlockPipeline,
    env_batch,
    env_batch_cap,
    stream_blocks,
)
