"""The reference's k=128 DAH golden through the port's one-shot extend on
the CPU (its own file: at this size the plain SHA-256 takes minutes, and
a file runs on one worker)."""

from __future__ import annotations

import chip_smoke
from celestia_app_tpu_torch.da import DataAvailabilityHeader, extend_shares


def test_k128_golden():
    eds = extend_shares([chip_smoke.golden_share()] * (128 * 128), device="cpu")
    assert DataAvailabilityHeader.from_eds(eds).hash().hex() == chip_smoke.K128_HASH
