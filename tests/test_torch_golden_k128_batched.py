"""The reference's k=128 DAH golden through the port's batched pipeline on
the CPU, two copies in one batch (its own file: at this size the plain
SHA-256 takes minutes, and a file runs on one worker; the MinDAH and k=2
cases are in tests/test_torch_pipeline.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.da import DataAvailabilityHeader
from celestia_app_tpu_torch.kernels.fused import extend_and_dah_batched_fn


@pytest.mark.parametrize("k,want", [(128, chip_smoke.K128_HASH)])
def test_goldens_through_batched_path(k, want):
    """Two copies of the k=128 golden square in one batch: every square's
    DAH is the golden."""
    ods = np.frombuffer(chip_smoke.golden_share() * (k * k), dtype=np.uint8).reshape(
        k, k, SHARE_SIZE)
    _, rows, cols, droots = extend_and_dah_batched_fn(k, 2, device="cpu")(
        torch.from_numpy(np.stack([ods, ods])))
    for b in range(2):
        dah = DataAvailabilityHeader([r.numpy().tobytes() for r in rows[b]],
                                     [c.numpy().tobytes() for c in cols[b]])
        assert dah.hash().hex() == want == droots[b].numpy().tobytes().hex()
