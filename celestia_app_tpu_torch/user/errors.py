"""Client-side error parsing (reference app/errors).

ParseInsufficientMinGasPrice (app/errors/insufficient_gas_price.go:23):
recover the node's actual minimum gas price from the fee-rejection message
so the client can bump its gas price and retry exactly once per level.
The port's copy of celestia_app_tpu/user/errors.py.
"""

from __future__ import annotations

import re
from fractions import Fraction

_MIN_GAS_PRICE_RE = re.compile(r"insufficient fees; got: (\d+)utia required: (\d+)utia")
_SEQ_MISMATCH_RE = re.compile(
    r"account sequence mismatch, expected (\d+), got (\d+)"
)


def parse_insufficient_min_gas_price(log: str, gas_limit: int) -> Fraction | None:
    """The node's min gas price implied by a fee-rejection log, or None."""
    m = _MIN_GAS_PRICE_RE.search(log)
    if not m:
        return None
    required = int(m.group(2))
    if required == 0 or gas_limit == 0:
        return None
    return Fraction(required, gas_limit)


def parse_nonce_mismatch(log: str) -> tuple[int, int] | None:
    """(expected, got) sequence numbers from a nonce-mismatch log, or None
    (reference app/errors/nonce_mismatch.go)."""
    m = _SEQ_MISMATCH_RE.search(log)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2))
