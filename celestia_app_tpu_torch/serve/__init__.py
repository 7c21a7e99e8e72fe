"""The proof-serving plane, the read side of data availability.

  cache.py    ForestCache: the EDS and both NMT forests of the last
              $CELESTIA_SERVE_HEIGHTS heights on the device (LRU), with a
              host tier below it.
  sampler.py  ProofSampler: queued DAS sample requests answered a whole
              batch at a time by gathers from the cached forest, with a
              host lowering pinned to the same bytes.
  verify.py   verify_proofs: a queue of share proofs decided on the device.
  shard.py    the sharded plane: forests row-partitioned over a serve mesh
              ($CELESTIA_SERVE_SHARDS), share reads routed to the owning
              shard of a row-sharded EDS.

The port of celestia_app_tpu/serve (cache, sampler, verify, shard).
"""

from celestia_app_tpu_torch.serve.cache import (  # noqa: F401
    ForestCache,
    serve_heights,
    spill_heights,
)
from celestia_app_tpu_torch.serve.sampler import ProofSampler, serve_mode  # noqa: F401
