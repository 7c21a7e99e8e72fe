"""The plain reference of a data-availability square: ODS -> EDS -> row and
column roots -> data root, from the benchmark's own inputs alone.  It
imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from dabench.reference import nmt
from dabench.reference.codec import Codec


class Reference:
    """Extension and roots for squares of one size and construction.

    `dtype` float32 is the reference; bfloat16 is the control."""

    def __init__(self, k: int, construction: str, device, dtype=torch.float32):
        self.k = k
        self.device = torch.device(device)
        self.codec = Codec(k, construction, self.device, dtype)
        self._args = (k, construction, self.device, dtype)
        self._recover = None

    def recover_ods(self, eds: torch.Tensor) -> torch.Tensor:
        """The ODS of an EDS whose Q0 is missing, from Q1: each row's data
        is the interpolation of its parity half back to the data points."""
        if self._recover is None:
            self._recover = Codec(*self._args, recover=True)
        return self._recover.parity(eds.to(self.device)[:self.k, self.k:].contiguous())

    def eds(self, ods) -> torch.Tensor:
        """(k, k, 512) uint8, numpy or tensor -> (2k, 2k, 512) on the device."""
        if not isinstance(ods, torch.Tensor):
            ods = torch.from_numpy(np.array(ods, dtype=np.uint8))
        return self.codec.extend(ods.to(self.device))

    def roots(self, odss) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Row roots (B, 2k, 90), column roots (B, 2k, 90) and data roots
        (B, 32), host uint8, of B squares."""
        digests = torch.stack([nmt.leaf_digests(self.eds(ods), self.k) for ods in odss])
        rr, cr, dr = nmt.roots(digests)
        return rr.cpu().numpy(), cr.cpu().numpy(), dr.cpu().numpy()
