from celestia_app_tpu_torch.testutil.testnode import (
    BLOCK_INTERVAL_NS,
    DEFAULT_BALANCE,
    GENESIS_TIME_NS,
    TestNode,
    deterministic_genesis,
    funded_keys,
)

__all__ = [
    "BLOCK_INTERVAL_NS",
    "DEFAULT_BALANCE",
    "GENESIS_TIME_NS",
    "TestNode",
    "deterministic_genesis",
    "funded_keys",
]
