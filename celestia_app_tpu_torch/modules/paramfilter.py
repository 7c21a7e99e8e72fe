"""x/paramfilter: governance cannot touch consensus-critical params.

Parity with reference x/paramfilter/gov_handler.go:16-36 and the blocked set
wired at app/app.go:739-750.
"""

from __future__ import annotations

# (module subspace, key) pairs governance may never change.
PARAM_BLOCK_LIST: frozenset[tuple[str, str]] = frozenset(
    {
        ("bank", "SendEnabled"),
        ("staking", "UnbondingTime"),
        ("staking", "BondDenom"),
        ("consensus", "validator.pub_key_types"),
    }
)


class ForbiddenParamError(ValueError):
    pass


def validate_param_changes(changes: list[tuple[str, str, str]]) -> None:
    """Reject a gov proposal touching any blocked (subspace, key).

    The reference handler rejects the whole proposal if any change is
    blocked (gov_handler.go:36 GovHandler).
    """
    for subspace, key, _value in changes:
        if (subspace, key) in PARAM_BLOCK_LIST:
            raise ForbiddenParamError(
                f"parameter {subspace}/{key} cannot be changed by governance"
            )
