"""The JAX node's own callers on the port's CryptoSuite, on the CPU
(``device="cpu"``): a 4-node in-process chain, transaction admission,
the signature-list check and the state and transaction roots.

The chain swaps the port's ecdsa suite in by monkeypatching
``fisco_bcos_tpu.node.node.ecdsa_suite``, and sends ``batch_admit``'s fused
branch (txpool/validator.py:134) to the port by monkeypatching
``fisco_bcos_tpu.crypto.admission.admit_batch`` with the port's
``admit_batch``. While the port suite serves the node, every JAX batch
entry the seam could reach (the signature impls' ``batch_verify`` and
``batch_recover``, Ed25519's ``verify_batch``, ``CryptoSuite.hash_batch(_async)``,
``merkle_root_async`` and ``merkle_tree``) is patched to fail and to
record the call, so a JAX batch call cannot pass unseen. The JAX suite then
checks what the chain committed on its host legs: single-item hashes and
recovery, its host merkle tree and the native verify loop of
``BlockValidator``. The SM suite is held at the ``batch_admit`` level,
where ``batch_admit`` takes its three-call branch (txpool/validator.py:
143-149) through the port. The QC certificates of 4- and 7-member
committees run through ``consensus.qc.Ed25519QCScheme`` with the port's
``Ed25519Crypto`` as its implementation, every JAX Ed25519 batch entry made
to fail, against the same scheme on the JAX suite's host legs. The BLS
certificates of a 4-member committee run through ``consensus.qc.BLSQCScheme``
with the port's ``BLSCrypto`` (plain PyTorch pairing checks on the CPU),
every case at once through a DevicePlane that merges them into one pairing
batch, against the scheme on the JAX ``BLSCrypto``; two threads' aggregate
checks merged by the plane against their direct calls; and the light
client's header sync (``succinct.sync.verify_header_batch`` under
``LightNode.sync_headers``) with the BLS scheme's implementation set to the
port's ``BLSCrypto``, its one aggregate check the port's multi-pairing
(plain PyTorch on the CPU), every JAX multi-pairing entry made to fail."""

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.codec.abi import ABICodec
from fisco_bcos_tpu.consensus import BlockValidator
from fisco_bcos_tpu.consensus import qc
from fisco_bcos_tpu.crypto import bls as jbls
from fisco_bcos_tpu.crypto import admission as jadmission
from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.executor.precompiled import DAG_TRANSFER_ADDRESS
from fisco_bcos_tpu.front import InprocGateway
from fisco_bcos_tpu.ledger import ConsensusNode, GenesisConfig
from fisco_bcos_tpu.node import Node, NodeConfig
from fisco_bcos_tpu.node import node as node_module
from fisco_bcos_tpu.ops.merkle import MerkleTree
from fisco_bcos_tpu.protocol.block import Block
from fisco_bcos_tpu.protocol.block_header import BlockHeader
from fisco_bcos_tpu.protocol.transaction import Transaction, TransactionFactory
from fisco_bcos_tpu.storage.entry import Entry
from fisco_bcos_tpu.storage.state_storage import StateStorage
from fisco_bcos_tpu.succinct import sync as jsync
from fisco_bcos_tpu.txpool.validator import batch_admit
from fisco_bcos_tpu.ops import bls12_381 as jbls_ops
from fisco_bcos_tpu.ops import ed25519 as jed
from fisco_bcos_tpu_torch.crypto import admission, bls, suite
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.device.plane import DevicePlane
from fisco_bcos_tpu_torch.ops import _kernels
from fisco_bcos_tpu_torch.ops import bls12_381 as bls_ops
from test_succinct import _bls_chain, _stub_light

PORT = suite.ecdsa_suite(device="cpu")
PORT_SM = suite.sm_suite(device="cpu")
JAX = jsuite.ecdsa_suite()
JAX_SM = jsuite.sm_suite()


@dataclass(frozen=True)
class HostLegs(jsuite.CryptoSuite):
    """A JAX suite whose batch hash is its single-item host hash, a message
    at a time (its own batch hash runs a JAX program)."""

    def hash_batch(self, msgs) -> np.ndarray:
        return np.frombuffer(b"".join(map(self.hash, msgs)), dtype=np.uint8).reshape(-1, 32)

    def hash_batch_async(self, msgs):
        out = self.hash_batch(msgs)
        return lambda: out


@contextlib.contextmanager
def port_seam():
    """The JAX node's JAX batch crypto entries made to fail (recording each
    call) and its fused admission sent to the port; yields the calls."""
    calls = []

    def jax_batch(name):
        def fail(*_args, **_kwargs):
            calls.append(name)
            pytest.fail(f"a JAX batch crypto entry ran: {name}")

        return fail

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        for cls, names in (
            (jsuite.Secp256k1Crypto, ("batch_verify", "batch_recover")),
            (jsuite.SM2Crypto, ("batch_verify", "batch_recover")),
            (jsuite.Ed25519Crypto, ("batch_verify", "batch_recover")),
            (jed, ("verify_batch",)),
            (jbls.BLSCrypto, ("aggregate_verify_batch", "multi_pairing_verify")),
            (jbls_ops, ("pairing_check_batch", "multi_pairing_check")),
            (jsuite.CryptoSuite, ("hash_batch", "hash_batch_async", "merkle_root_async", "merkle_tree")),
        ):
            for name in names:
                mp.setattr(cls, name, jax_batch(f"{cls.__name__}.{name}"))
        mp.setattr(jadmission, "admit_batch", lambda payloads, sigs: admission.admit_batch(payloads, sigs, device="cpu"))
        mp.setattr(node_module, "ecdsa_suite", lambda: PORT)
        yield calls


def _signed_txs(factory, kp, count, tag="n"):
    codec = ABICodec(factory.suite.hash)
    return [
        factory.create_signed(
            kp,
            chain_id="chain0",
            group_id="group0",
            block_limit=500,
            nonce=f"{tag}{i}",
            to=DAG_TRANSFER_ADDRESS,
            input=codec.encode_call("userAdd(string,uint256)", f"u{tag}{i}", 100),
        )
        for i in range(count)
    ]


@pytest.fixture(scope="module")
def chain():
    """Four nodes on the port's ecdsa suite commit one block of 4 txs (the
    tests/test_pbft.py make_chain pattern)."""
    with port_seam() as calls:
        keypairs = [PORT.signature_impl.generate_keypair(secret=10_000 + i) for i in range(4)]
        committee = [ConsensusNode(kp.pub, weight=1) for kp in keypairs]
        gateway = InprocGateway(auto=True)
        nodes = []
        for kp in keypairs:
            node = Node(NodeConfig(genesis=GenesisConfig(consensus_nodes=list(committee))), keypair=kp)
            gateway.connect(node.front)
            nodes.append(node)
        assert all(n.suite is PORT for n in nodes)
        leader = next(n for n in nodes if n.pbft_config.is_leader(1, 0))
        user = PORT.signature_impl.generate_keypair(secret=777)
        txs = _signed_txs(TransactionFactory(PORT), user, 4)
        assert all(r.status == 0 for r in leader.txpool.submit_batch(txs))
        leader.tx_sync.maintain()
        assert leader.sealer.seal_and_submit()
        proof = nodes[1].ledger.tx_proof(txs[2].hash(PORT))
        committed_calls = list(calls)
    yield nodes, txs, proof, committed_calls
    for n in nodes:
        n.stop()


def test_chain_commits_on_the_port_suite(chain):
    nodes, txs, _, calls = chain
    assert not calls  # no JAX batch crypto entry ran
    assert all(n.block_number() == 1 for n in nodes)
    assert len({n.ledger.block_hash_by_number(1) for n in nodes}) == 1
    roots = {n.ledger.header_by_number(1).state_root for n in nodes}
    assert len(roots) == 1 and roots != {bytes(32)}
    assert nodes[0].ledger.tx_hashes_by_number(1) == [t.hash(PORT) for t in txs]


def test_jax_suite_recomputes_the_committed_block(chain):
    """Roots, tx hashes and senders recomputed by the JAX suite on its host
    legs, its BlockValidator accepting the header, and a tx proof the port
    suite built verifying under the JAX verifier."""
    nodes, txs, (items, idx, n), _ = chain
    ledger = nodes[0].ledger
    header = ledger.header_by_number(1)
    block = ledger.block_by_number(1, with_receipts=True)
    assert len(block.transactions) == len(block.receipts) == len(txs)
    host = HostLegs(JAX.hash_impl, JAX.signature_impl)
    hashes = [JAX.hash(t.encode_data()) for t in block.transactions]
    assert hashes == ledger.tx_hashes_by_number(1)
    leaves = np.frombuffer(b"".join(hashes), dtype=np.uint8).reshape(-1, 32)
    assert JAX.merkle_root_async(leaves)() == header.txs_root
    assert Block(transactions=block.transactions, receipts=block.receipts).calculate_receipts_root(host) == header.receipts_root
    for t, h in zip(txs, hashes):
        assert t.sender == JAX.calculate_address(JAX.signature_impl.recover(h, t.signature))
    assert BlockValidator(JAX).check_block(header, ledger.consensus_nodes())
    assert (idx, n) == (2, len(txs))
    assert MerkleTree.verify_proof(hashes[2], idx, n, items, header.txs_root)


def test_block_validator_on_the_port_suite(chain):
    nodes, _, _, _ = chain
    header = nodes[0].ledger.header_by_number(1)
    committee = nodes[0].ledger.consensus_nodes()
    with port_seam() as calls:
        validator = BlockValidator(PORT)
        assert validator.check_block(header, committee)
        forged = BlockHeader.decode(header.encode())
        forged.state_root = b"\xde" * 32
        forged.clear_hash_cache()
        assert not validator.check_block(forged, committee)
    assert not calls


def test_batch_admit_sm_takes_the_three_call_branch():
    """batch_admit on the port's SM suite: hash_batch -> batch_recover ->
    calculate_address_batch, a corrupted and a short signature among the
    txs; the results the JAX SM suite gives one tx at a time on the host."""
    kp = PORT_SM.signature_impl.generate_keypair(secret=0x5151)
    txs = _signed_txs(TransactionFactory(PORT_SM), kp, 4, tag="sm")
    bad = bytearray(txs[2].signature)
    bad[40] ^= 1
    txs[2].signature = bytes(bad)
    txs[3].signature = txs[3].signature[:-1]
    fresh = [Transaction.decode(t.encode()) for t in txs]  # no cached hash or sender
    with port_seam() as calls:
        ok = batch_admit(fresh, PORT_SM)
    assert not calls
    np.testing.assert_array_equal(ok, [True, True, False, False])
    sender = JAX_SM.calculate_address(kp.pub)
    for t, good in zip(fresh, ok):
        assert t._hash == JAX_SM.hash(t.encode_data())
        if good:
            assert t.sender == sender == JAX_SM.calculate_address(JAX_SM.signature_impl.recover(t._hash, t.signature))
        else:
            assert t.sender != sender


def test_state_and_tx_roots_match_the_jax_host_legs():
    """StateStorage's XOR state root (storage/state_storage.py:140) and a
    Block's transaction and receipt roots on the port suites equal the JAX
    suites' on their host legs."""
    for port, jax_suite in ((PORT, JAX), (PORT_SM, JAX_SM)):
        host = HostLegs(jax_suite.hash_impl, jax_suite.signature_impl)
        state = StateStorage()
        for i in range(9):
            state.set_row(f"t{i % 3}", b"key %d" % i, Entry().set(b"value %d" % i * (i + 1)))
        with port_seam() as calls:
            got = state.hash(port)
        assert not calls
        assert got == state.hash(host) and got != bytes(32)
        kp = port.signature_impl.generate_keypair(secret=0xB10C)
        txs = _signed_txs(TransactionFactory(port), kp, 5, tag="root")
        with port_seam() as calls:
            root = Block(transactions=list(txs)).calculate_txs_root(port)
        assert not calls
        fresh = [Transaction.decode(t.encode()) for t in txs]
        assert root == Block(transactions=fresh).calculate_txs_root(host)


def _qc_cases(scheme, members: int):
    """A committee's keys, one vote preimage, a quorum's certificate, and the
    certificates and key lists verify_cert must reject: one swapped
    signature, a signer's key missing, an agg_sig one byte short."""
    kps = [scheme.derive_keypair(secret=0x9C00 + 31 * i) for i in range(members)]
    pubs = [kp.pub for kp in kps]
    msg32 = qc.vote_preimage(PORT, 3, 7, 42, bytes(range(32)))
    signers = list(range(members - (members - 1) // 3))  # 2f + 1
    votes = {i: scheme.sign_vote(kps[i], msg32) for i in signers}
    swapped = dict(votes)
    swapped[signers[0]] = votes[signers[1]]
    cert = scheme.build_cert(votes, members)
    missing = list(pubs)
    missing[signers[-1]] = b""
    short = qc.QuorumCert(cert.scheme, cert.committee, cert.bitmap, cert.agg_sig[:-1])
    return {
        "quorum": (cert, pubs, msg32),
        "one swapped signature": (scheme.build_cert(swapped, members), pubs, msg32),
        "a missing pubkey": (cert, missing, msg32),
        "a wrong-length agg_sig": (short, pubs, msg32),
    }, votes, kps


@pytest.mark.parametrize("members", [4, 7])
def test_qc_certificates_on_the_port_ed25519(members):
    """Ed25519QCScheme, the default QC scheme, on the port's Ed25519Crypto
    (plain PyTorch on the CPU): it derives the JAX scheme's keys, signs its
    votes byte for byte, builds its certificate, accepts a quorum and
    rejects a swapped signature, a missing key and a short agg_sig, as the
    scheme on the JAX suite does; no JAX batch entry runs."""
    jax_scheme = qc.Ed25519QCScheme()
    jax_cases, jax_votes, jax_kps = _qc_cases(jax_scheme, members)
    want = {what: jax_scheme.verify_cert(*args) for what, args in jax_cases.items()}
    assert want == {"quorum": True, "one swapped signature": False,
                    "a missing pubkey": False, "a wrong-length agg_sig": False}
    scheme = qc.Ed25519QCScheme()
    scheme._impl = suite.Ed25519Crypto(torch.device("cpu"))
    with port_seam() as calls:
        cases, votes, kps = _qc_cases(scheme, members)
        assert [kp.pub for kp in kps] == [kp.pub for kp in jax_kps]
        assert votes == jax_votes
        for what, (cert, pubs, msg32) in cases.items():
            assert cert.encode() == jax_cases[what][0].encode(), what
            assert scheme.verify_cert(cert, pubs, msg32) == want[what], what
        i = next(iter(votes))
        assert scheme.verify_one(kps[i].pub, cases["quorum"][2], votes[i])
    assert not calls


def _bls_qc_cases(scheme):
    """A 4-member committee's BLS keys, one vote preimage, the quorum's
    certificate (signers 0-2), and what verify_cert must reject: an agg_sig
    with one bit flipped, a bitmap naming member 3 too, a wrong message."""
    members = 4
    kps = [scheme.derive_keypair(secret=0xB100 + 31 * i) for i in range(members)]
    pubs = [kp.pub for kp in kps]
    msg32 = qc.vote_preimage(PORT, 3, 7, 42, bytes(range(32)))
    votes = {i: scheme.sign_vote(kps[i], msg32) for i in range(3)}
    cert = scheme.build_cert(votes, members)
    flipped = bytearray(cert.agg_sig)
    flipped[20] ^= 1
    extra = qc.QuorumCert(cert.scheme, cert.committee, qc.QuorumCert.make_bitmap([0, 1, 2, 3], members), cert.agg_sig)
    return {
        "quorum": (cert, pubs, msg32),
        "a tampered agg_sig": (qc.QuorumCert(cert.scheme, cert.committee, cert.bitmap, bytes(flipped)), pubs, msg32),
        "a bitmap naming an extra member": (extra, pubs, msg32),
        "a wrong message": (cert, pubs, qc.vote_preimage(PORT, 3, 7, 43, bytes(range(32)))),
    }, votes, kps


def _concurrently(calls) -> list:
    """Each call on a thread of its own, all started together; their
    results in order (an exception is re-raised here)."""
    out = [None] * len(calls)

    def run(i, fn):
        try:
            out[i] = ("ok", fn())
        except Exception as e:  # noqa: BLE001 — handed back to the test's thread
            out[i] = ("raised", e)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for kind, value in out:
        if kind == "raised":
            raise value
    return [value for _, value in out]


@pytest.fixture
def merging_plane(monkeypatch):
    """A fresh DevicePlane whose window holds until `items` lanes are
    queued, so concurrent callers merge into one dispatch."""

    def make(items: int) -> DevicePlane:
        plane = DevicePlane(window_ms=60_000, high_water=items, starvation_ms=60_000)
        monkeypatch.setattr(plane_mod, "_PLANE", plane)
        return plane

    return make


def test_qc_certificates_on_the_port_bls(merging_plane, monkeypatch):
    """BLSQCScheme on the port's BLSCrypto (plain PyTorch on the CPU): it
    derives the JAX scheme's keys, signs its votes and builds its
    certificate byte for byte; it accepts the quorum and rejects a tampered
    agg_sig, a bitmap naming an extra member and a wrong message, as the
    scheme on the JAX BLSCrypto does, the four checks merged by the plane
    into one pairing batch; the JAX scheme gives the same verdicts on the
    port's certificates; no JAX batch entry runs; an agg_sig that fails to
    decompress is rejected before any pairing."""
    jax_scheme = qc.BLSQCScheme()
    jax_cases, jax_votes, jax_kps = _bls_qc_cases(jax_scheme)
    want = {what: jax_scheme.verify_cert(*args) for what, args in jax_cases.items()}
    assert want == {"quorum": True, "a tampered agg_sig": False,
                    "a bitmap naming an extra member": False, "a wrong message": False}
    scheme = qc.BLSQCScheme()
    scheme._impl = bls.BLSCrypto(torch.device("cpu"))
    with port_seam() as calls:
        cases, votes, kps = _bls_qc_cases(scheme)
        assert [kp.pub for kp in kps] == [kp.pub for kp in jax_kps]
        assert votes == jax_votes
        for what, (cert, _, _) in cases.items():
            assert cert.encode() == jax_cases[what][0].encode(), what
        plane = merging_plane(len(cases))
        got = _concurrently([lambda args=args: scheme.verify_cert(*args) for args in cases.values()])
        assert dict(zip(cases, got)) == want
        assert plane.stats()["dispatches"] == 1
        i = next(iter(votes))
        assert scheme.verify_one(kps[i].pub, cases["quorum"][2], votes[i])
        assert bls._g2_point(cases["a tampered agg_sig"][0].agg_sig) is None
        monkeypatch.setattr(bls_ops, "pairing_check_device", lambda rows: pytest.fail("a pairing ran"))
        monkeypatch.setenv("FISCO_DEVICE_PLANE", "0")  # alone, it need not wait for the window
        assert not scheme.verify_cert(*cases["a tampered agg_sig"])
    assert not calls
    assert {what: jax_scheme.verify_cert(*args) for what, args in cases.items()} == want


def test_bls_aggregate_checks_merge_on_the_plane(merging_plane, monkeypatch):
    """Two threads' aggregate_verify_batch calls released together through
    the port's plane make one dispatch, and each gets the bits of its own
    direct call (FISCO_DEVICE_PLANE=0): one caller's checks a quorum and a
    wrong message, the other's an agg_sig and a signer set that do not
    decode (its direct call needs no pairing; in the merged batch they are
    lanes on the substitutes)."""
    crypto = bls.BLSCrypto(torch.device("cpu"))
    cases, _, kps = _bls_qc_cases(qc.BLSQCScheme())
    checks = {what: ([pubs[i] for i in cert.signers()], msg32, cert.agg_sig)
              for what, (cert, pubs, msg32) in cases.items()}
    a = [checks["quorum"], checks["a wrong message"]]
    b = [checks["a tampered agg_sig"], ([kps[0].pub, b"\x00" * 48], *checks["quorum"][1:])]
    monkeypatch.setenv("FISCO_DEVICE_PLANE", "0")
    direct = [crypto.aggregate_verify_batch(a), crypto.aggregate_verify_batch(b)]
    assert [list(d) for d in direct] == [[True, False], [False, False]]
    monkeypatch.delenv("FISCO_DEVICE_PLANE")
    plane = merging_plane(len(a) + len(b))
    merged = _concurrently([lambda: crypto.aggregate_verify_batch(a), lambda: crypto.aggregate_verify_batch(b)])
    assert [m.tolist() for m in merged] == [d.tolist() for d in direct]
    assert plane.stats()["dispatches"] == 1 and plane.stats()["requests"] == 2


def test_header_sync_on_the_port_bls(monkeypatch):
    """The JAX light client's header sync with the BLS scheme on the port's
    BLSCrypto: LightNode.sync_headers adopts a chunk of 3 chain-linked
    headers through one verify_header_batch that returns True (one
    multi_pairing_verify of 4 pairs); on a chunk whose last header was
    tampered after signing, verify_header_batch returns False and the
    per-header fallback (check_block, the port's aggregate_verify) adopts
    the first two and names the third; a header with no QC is not
    aggregatable (None) and runs no pairing. The JAX scheme gives the same
    verdicts, and no JAX batch or multi-pairing entry runs."""
    good, committee, _, _ = _bls_chain(3, secret=55_101, tag=b"port-sync")
    evil, evil_committee, _, _ = _bls_chain(3, secret=55_102, tag=b"port-evil")
    evil[2].gas_used = 999_999
    evil[2].clear_hash_cache()
    validator = BlockValidator(jsuite.ecdsa_suite())
    want = [jsync.verify_header_batch(good, committee, validator),
            jsync.verify_header_batch(evil, evil_committee, validator)]
    assert want == [True, False]
    bare = BlockHeader(number=1, sealer_list=[committee[0].node_id], consensus_weights=[1])
    returned = []
    real = jsync.verify_header_batch

    def recording(*args):
        returned.append(real(*args))
        return returned[-1]

    monkeypatch.setattr(qc.get_scheme("bls"), "_impl", bls.BLSCrypto(torch.device("cpu")))
    monkeypatch.setattr(jsync, "verify_header_batch", recording)
    with port_seam() as calls:
        light = _stub_light(good, committee)
        assert light.sync_headers() == 3 and set(light.headers) == {1, 2, 3}
        assert returned == [True]
        light = _stub_light(evil, evil_committee)
        with pytest.raises(ValueError, match="header 3 fails QC"):
            light.sync_headers()
        assert returned == [True, False] == want and light.head == 2
        monkeypatch.setattr(bls_ops, "multi_pairing_device", lambda rows: pytest.fail("a pairing ran"))
        assert real([bare], committee, validator) is None
    assert not calls

