"""Signer: builds and signs txs and BlobTxs for known accounts.

Parity with reference pkg/user/signer.go:23-36 + account.go: tracks
(account number, sequence) per local key, produces TxRaw bytes for message
txs and BlobTx envelopes for PFBs.  The port's copy of
celestia_app_tpu/user/signer.py: the same keys, numbers and sequences sign
the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.modules.blob.types import new_msg_pay_for_blobs
from celestia_app_tpu_torch.shares.sparse import Blob
from celestia_app_tpu_torch.tx.envelopes import BlobTx
from celestia_app_tpu_torch.tx.messages import Coin
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign


@dataclass
class SignerAccount:
    key: PrivateKey
    account_number: int
    sequence: int

    @property
    def address(self) -> str:
        return self.key.public_key().address()


class Signer:
    def __init__(self, chain_id: str):
        self.chain_id = chain_id
        self._accounts: dict[str, SignerAccount] = {}

    def add_account(self, key: PrivateKey, account_number: int, sequence: int = 0) -> str:
        acc = SignerAccount(key, account_number, sequence)
        self._accounts[acc.address] = acc
        return acc.address

    def account(self, address: str) -> SignerAccount:
        return self._accounts[address]

    def addresses(self) -> list[str]:
        return list(self._accounts)

    def create_tx(
        self, address: str, msgs: list, gas: int, fee_utia: int,
        fee_granter: str = "",
    ) -> bytes:
        acc = self._accounts[address]
        raw = build_and_sign(
            msgs,
            acc.key,
            self.chain_id,
            acc.account_number,
            acc.sequence,
            Fee((Coin("utia", fee_utia),), gas, granter=fee_granter),
        )
        return raw

    def create_pay_for_blobs(
        self, address: str, blobs: list[Blob], gas: int, fee_utia: int,
        fee_granter: str = "",
    ) -> bytes:
        """BlobTx bytes for a PFB (signer.CreatePayForBlobs)."""
        msg = new_msg_pay_for_blobs(address, blobs)
        raw_tx = self.create_tx(address, [msg], gas, fee_utia, fee_granter)
        return BlobTx(raw_tx, tuple(blobs)).marshal()

    def increment_sequence(self, address: str) -> None:
        self._accounts[address].sequence += 1

    def set_sequence(self, address: str, sequence: int) -> None:
        self._accounts[address].sequence = sequence
