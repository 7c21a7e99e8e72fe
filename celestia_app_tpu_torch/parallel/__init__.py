"""The multi-device plane and block streaming.

  mesh.py            Mesh (one stream per shard; a tuple that repeats one
                     card runs logical shards on it), device_mesh, the copy
                     collectives and RowSharded, the row-sharded array;
  sharded_eds.py     the extend + DAH with the square's rows over a mesh;
  sharded_repair.py  repair with each decode group's lines over a mesh;
  pipeline.py        BlockPipeline and stream_blocks.

The ports of celestia_app_tpu/parallel (mesh, sharded_eds, sharded_repair,
pipeline).  parallel/_compat.py, which papers over a JAX API move, has no
counterpart.  The sharded panel lowering is kernels/panel_sharded.py, the
sharded serving plane serve/shard.py.
"""

from celestia_app_tpu_torch.parallel.pipeline import (  # noqa: F401
    BlockPipeline,
    env_batch,
    env_batch_cap,
    stream_blocks,
)
