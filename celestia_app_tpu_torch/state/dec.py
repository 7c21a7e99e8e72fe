"""18-decimal fixed-point arithmetic (sdk.Dec parity).

The mint schedule and fee checks are consensus-critical; the reference
computes them with cosmos-sdk's Dec — integers scaled by 1e18 with
round-half-to-even at each multiplication (x/mint/types/minter.go,
app/ante/fee_checker.go).  Python floats would drift; this mirrors the Dec
semantics the schedule depends on.
"""

from __future__ import annotations

from dataclasses import dataclass

PRECISION = 10**18


def _round_half_even(numerator: int, denominator: int) -> int:
    q, r = divmod(numerator, denominator)
    double = 2 * r
    if double > denominator or (double == denominator and q % 2):
        q += 1
    return q


@dataclass(frozen=True)
class Dec:
    """A fixed-point decimal: value = raw / 1e18."""

    raw: int

    @classmethod
    def from_int(cls, n: int) -> "Dec":
        return cls(n * PRECISION)

    @classmethod
    def from_str(cls, s: str) -> "Dec":
        if "." in s:
            whole, frac = s.split(".")
            frac = (frac + "0" * 18)[:18]
        else:
            whole, frac = s, "0" * 18
        sign = -1 if whole.startswith("-") else 1
        whole = whole.lstrip("-")
        return cls(sign * (int(whole or "0") * PRECISION + int(frac)))

    @classmethod
    def from_fraction(cls, num: int, den: int) -> "Dec":
        return cls(_round_half_even(num * PRECISION, den))

    def mul(self, other: "Dec") -> "Dec":
        return Dec(_round_half_even(self.raw * other.raw, PRECISION))

    def quo(self, other: "Dec") -> "Dec":
        return Dec(_round_half_even(self.raw * PRECISION, other.raw))

    def add(self, other: "Dec") -> "Dec":
        return Dec(self.raw + other.raw)

    def sub(self, other: "Dec") -> "Dec":
        return Dec(self.raw - other.raw)

    def power(self, n: int) -> "Dec":
        """Repeated truncating multiplication (sdk.Dec.Power semantics)."""
        result = Dec.from_int(1)
        base = self
        e = n
        while e:
            if e & 1:
                result = result.mul(base)
            base = base.mul(base)
            e >>= 1
        return result

    def mul_int(self, n: int) -> "Dec":
        return Dec(self.raw * n)

    def truncate_int(self) -> int:
        """Truncate toward zero to an integer."""
        if self.raw >= 0:
            return self.raw // PRECISION
        return -((-self.raw) // PRECISION)

    def ceil_int(self) -> int:
        return -((-self.raw) // PRECISION)

    def __lt__(self, other: "Dec") -> bool:
        return self.raw < other.raw

    def __le__(self, other: "Dec") -> bool:
        return self.raw <= other.raw

    def __str__(self) -> str:
        sign = "-" if self.raw < 0 else ""
        a = abs(self.raw)
        return f"{sign}{a // PRECISION}.{a % PRECISION:018d}"
