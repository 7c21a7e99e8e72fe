"""The port's Blobstream bridge client (crypto/keccak.py,
modules/blobstream/{evm,relayer}.py), held against the JAX package's.

Host functions on the same inputs: Keccak-256 and SHA3-256 on published
vectors and at every length around the sponge's rate; the EVM ABI digests
(valset hash and sign bytes, data-commitment sign bytes, EVM addresses from
hex, bech32 and plain labels, the 2/3 threshold); orchestrator signatures
(RFC 6979, so the same bytes); and a `BlobstreamContract`'s decisions over
one sequence of submits and valset updates, refusals and their messages
included.  End to end: a port ServingNode (device="cpu") with the Blobstream
window at 5 blocks commits a PFB and a send, rotates its validator set at
height 6 and runs to height 11; both packages' relayers, through the same
JSON-RPC endpoint, relay the same attestations into their contracts and
give the same `verify_shares` / `verify_tx` / `verify_blob` answers; a
tampered share proof, a wrong data root and an unrelayed nonce are refused
by both.
"""

from __future__ import annotations

import dataclasses
import hashlib

import pytest
from chip_smoke import TamperedRemote

from celestia_app_tpu.crypto import keccak as jax_keccak
from celestia_app_tpu.crypto.keys import PrivateKey as JaxPrivateKey
from celestia_app_tpu.modules.blobstream import evm as jax_evm
from celestia_app_tpu.modules.blobstream import relayer as jax_relayer
from celestia_app_tpu.modules.blobstream.keeper import BridgeValidator as JaxBridgeValidator
from celestia_app_tpu.rpc.client import RemoteNode as JaxRemoteNode
from celestia_app_tpu_torch.crypto import keccak
from celestia_app_tpu_torch.crypto.keys import PrivateKey
from celestia_app_tpu_torch.modules.blob.types import estimate_gas
from celestia_app_tpu_torch.modules.blobstream import evm, relayer
from celestia_app_tpu_torch.modules.blobstream.keeper import BridgeValidator
from celestia_app_tpu_torch.rpc.client import RemoteNode
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.shares.namespace import Namespace
from celestia_app_tpu_torch.shares.sparse import Blob
from celestia_app_tpu_torch.state.staking import StakingKeeper, Validator
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.tx import tx_hash
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend
from celestia_app_tpu_torch.user import Signer

PORT = (keccak, evm, relayer, PrivateKey, BridgeValidator, RemoteNode)
JAX = (jax_keccak, jax_evm, jax_relayer, JaxPrivateKey, JaxBridgeValidator, JaxRemoteNode)
MESSAGES = [b"", b"abc", bytes(range(256)) * 3, b"transfer(address,uint256)"]


def test_keccak_vectors_equal_jax():
    assert keccak.keccak256(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak.keccak256(b"abc").hex() == \
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    msg = bytes(range(256)) * 2
    for n in [0, 1, 134, 135, 136, 137, 271, 272, 273, 500] + [len(m) for m in MESSAGES]:
        assert keccak.sha3_256(msg[:n]) == hashlib.sha3_256(msg[:n]).digest()
        assert keccak.keccak256(msg[:n]) == jax_keccak.keccak256(msg[:n])
    lanes = list(range(25))
    assert keccak.keccak_f1600(lanes) == jax_keccak.keccak_f1600(lanes)


def members(lib, powers=(100, 100, 100)):
    _, _, _, key_cls, bv, _ = lib
    return tuple(bv(key_cls.from_seed(f"orch-{i}".encode()).public_key().address(), p)
                 for i, p in enumerate(powers))


@dataclasses.dataclass
class Member:
    address: str
    power: int
    evm_address: str | None = None


def test_evm_digests_equal_jax():
    cases = [members(PORT), members(PORT, (400, 100, 7)),
             (Member("celestia1x", 5, "0x" + "ab" * 20), Member("plain-label", 9))]
    for ms in cases:
        assert evm.valset_hash(ms) == jax_evm.valset_hash(ms)
        assert evm.two_thirds_threshold(ms) == jax_evm.two_thirds_threshold(ms)
        for nonce in (1, 2, 2**64):
            assert evm.valset_sign_bytes(nonce, ms) == jax_evm.valset_sign_bytes(nonce, ms)
    root = hashlib.sha256(b"window").digest()
    assert evm.data_commitment_sign_bytes(7, root) == jax_evm.data_commitment_sign_bytes(7, root)
    for who in ("0x" + "12" * 20, "0x" + "34" * 24, members(PORT)[0].address, "label"):
        assert evm.evm_address_bytes(who) == jax_evm.evm_address_bytes(who)
    for mod in (evm, jax_evm):
        with pytest.raises(ValueError, match="32 bytes"):
            mod.data_commitment_sign_bytes(1, b"short")
    assert (evm.VS_DOMAIN_SEPARATOR, evm.DC_DOMAIN_SEPARATOR) == \
        (jax_evm.VS_DOMAIN_SEPARATOR, jax_evm.DC_DOMAIN_SEPARATOR)


def contract_script(lib) -> list:
    """One run of a contract through accepted and refused calls; returns
    what each call did (None, or the refusal's message) and the state."""
    _, _, rel, key_cls, bv, _ = lib
    keys = {m.address: key_cls.from_seed(f"orch-{i}".encode())
            for i, m in enumerate(members(lib))}
    orchs = [rel.Orchestrator(a, k) for a, k in keys.items()]
    contract = rel.BlobstreamContract(1, members(lib), {a: k.public_key() for a, k in keys.items()})
    root = hashlib.sha256(b"window").digest()
    new_keys = {f"new{i}": key_cls.from_seed(f"neworch-{i}".encode()) for i in range(2)}
    new_members = tuple(bv(a, 50) for a in new_keys)
    new_orchs = [rel.Orchestrator(a, k) for a, k in new_keys.items()]
    sigs = [o.sign_data_commitment(2, root) for o in orchs]
    forged = rel.OrchestratorSignature(sigs[0].validator, sigs[1].signature)
    calls = [
        lambda: contract.submit_data_root_tuple_root(2, root, sigs[:1]),
        lambda: contract.submit_data_root_tuple_root(2, root, sigs[:2]),
        lambda: contract.submit_data_root_tuple_root(2, root, [forged, *sigs[1:]]),
        lambda: contract.submit_data_root_tuple_root(2, root[:5], sigs),
        lambda: contract.submit_data_root_tuple_root(2, root, sigs + sigs),
        lambda: contract.submit_data_root_tuple_root(2, root, sigs),
        lambda: contract.update_valset(1, new_members, {}, [o.sign_valset(1, new_members)
                                                            for o in orchs]),
        lambda: contract.update_valset(3, new_members, {a: k.public_key()
                                                        for a, k in new_keys.items()},
                                       [o.sign_valset(3, new_members) for o in orchs]),
        lambda: contract.submit_data_root_tuple_root(4, root, [
            o.sign_data_commitment(4, root) for o in orchs]),
        lambda: contract.submit_data_root_tuple_root(4, root, [
            o.sign_data_commitment(4, root) for o in new_orchs]),
    ]
    out = []
    for call in calls:
        try:
            out.append(call())
        except rel.ContractError as e:
            out.append(str(e))
    out.append((contract.valset_nonce, contract.latest_nonce, contract.tuple_roots,
                [(m.address, m.power) for m in contract.members]))
    out.append([(s.validator, s.signature) for s in sigs])
    return out


def test_contract_decisions_and_signatures_equal_jax():
    got = contract_script(PORT)
    assert got == contract_script(JAX)
    assert got[:10] == ["insufficient signed power 100/300 (needs >2/3)",
                        "insufficient signed power 200/300 (needs >2/3)",
                        f"bad signature from {members(PORT)[0].address}",
                        "tuple root must be 32 bytes", None, "nonce 2 already relayed",
                        "valset nonce must increase", None,
                        "insufficient signed power 0/100 (needs >2/3)", None]
    assert got[-2][0] == 3 and 2 in got[-2][2] and 4 in got[-2][2]


@pytest.fixture(scope="module")
def chain():
    """A served port node past two Blobstream windows and a valset change;
    (server, the PFB's hash, the send's hash)."""
    keys = funded_keys(2)
    genesis = deterministic_genesis(keys, app_version=1, n_validators=3,
                                    data_commitment_window=5)
    node = ServingNode(genesis=genesis, keys=keys, device="cpu")
    server = serve(node, port=0, block_interval_s=None)
    signer = Signer(node.chain_id)
    for i, k in enumerate(keys):
        signer.add_account(k, i, 0)
    addr = signer.addresses()[0]
    blob = Blob(Namespace.v0(b"relayer-ns"), b"relayed blob payload " * 60)
    pfb = signer.create_pay_for_blobs(addr, [blob], estimate_gas([len(blob.data)]), 100_000)
    signer.increment_sequence(addr)
    send = signer.create_tx(addr, [MsgSend(addr, signer.addresses()[1], (Coin("utia", 5),))],
                            200_000, 20_000)
    for raw in (pfb, send):
        assert node.broadcast(raw).code == 0
    node.produce_block()
    for _ in range(4):
        node.produce_block()  # valset nonce 1, DC nonce 2 [1, 6)
    v0 = PrivateKey.from_seed(b"validator-0").public_key()
    StakingKeeper(node.app.cms.working).set_validator(Validator(v0.address(), v0.bytes, power=400))
    for _ in range(6):
        node.produce_block()  # valset nonce 3, DC nonce 4 [6, 11)
    yield server, tx_hash(pfb), tx_hash(send)
    server.stop()


def genesis_contract(lib, remote):
    """The contract registered with the chain's genesis valset, and the
    orchestrators of the deterministic validator keys."""
    _, _, rel, key_cls, bv, _ = lib
    vs = remote.latest_valset_before(remote.blobstream_nonces()["latest"])
    seeds = {key_cls.from_seed(f"validator-{i}".encode()).public_key().address():
             key_cls.from_seed(f"validator-{i}".encode()) for i in range(3)}
    contract = rel.BlobstreamContract(
        vs["nonce"], tuple(bv(m["address"], m["power"]) for m in vs["members"]),
        {a: k.public_key() for a, k in seeds.items()})
    return contract, [rel.Orchestrator(a, k) for a, k in seeds.items()]


def relay_and_verify(lib, url, pfb, send) -> list:
    _, _, rel, _, _, remote_cls = lib
    remote = remote_cls(url)
    contract, orchs = genesis_contract(lib, remote)
    out = [rel.relay_pending(remote, contract, orchs),
           rel.relay_pending(remote, contract, orchs),
           (contract.valset_nonce, sorted(contract.tuple_roots.items()),
            sorted((m.address, m.power) for m in contract.members))]
    out += [rel.verify_blob(remote, contract, pfb, 0), rel.verify_tx(remote, contract, pfb),
            rel.verify_tx(remote, contract, send), rel.verify_blob(remote, contract, send, 0),
            rel.verify_blob(remote, contract, pfb, 3), rel.verify_tx(remote, contract, b"\x01" * 32),
            rel.verify_shares(remote, contract, 1, 0, 1), rel.verify_shares(remote, contract, 7, 0, 1),
            rel.verify_blob(TamperedRemote(remote), contract, pfb, 0)]
    dc = remote.data_commitment_range(1)
    index, total, path = remote.data_root_inclusion_proof(1, dc["begin_block"], dc["end_block"])
    root = remote.block(1)["data_hash"]
    wrong = hashlib.sha256(b"not the data root").digest()
    out += [contract.verify_attestation(dc["nonce"], 1, bytes.fromhex(root), index, total, path),
            contract.verify_attestation(dc["nonce"], 1, wrong, index, total, path),
            contract.verify_attestation(dc["nonce"] + 99, 1, bytes.fromhex(root), index, total,
                                        path)]
    return out


def test_relayer_end_to_end_equal_jax(chain):
    server, pfb, send = chain
    got = relay_and_verify(PORT, server.url, pfb, send)
    assert got == relay_and_verify(JAX, server.url, pfb, send)
    relayed, again, (valset_nonce, roots, _), *verdicts = got
    assert (relayed, again, valset_nonce, [n for n, _ in roots]) == (2, 0, 3, [2, 4])
    assert verdicts == [True, True, True, False, False, False, True, True, False,
                        True, False, False]
