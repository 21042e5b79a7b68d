"""The port's codec, protocol objects, storage and ledger
(``fisco_bcos_tpu_torch/{codec,protocol,storage,ledger}``) against the JAX
package's, on the CPU, byte for byte: encodings and hashes of transactions,
receipts, headers and blocks; the txs and receipts roots; the ledger's rows
after genesis and two prewritten blocks, row for row through
``traverse()``; the overlay's state hash; the durable backend's two-phase
commit; and a chain the JAX ledger wrote, carried into the port by
``MemoryStorage.from_rows``. The JAX side runs on its suite's host legs, so
no JAX program is traced, and no signature batch runs on either side."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import pytest

from fisco_bcos_tpu.codec import flat as jflat
from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu import ledger as jledger
from fisco_bcos_tpu import protocol as jprotocol
from fisco_bcos_tpu import storage as jstorage
from fisco_bcos_tpu.ledger import ledger as jledger_mod
from fisco_bcos_tpu.ops.merkle import MerkleTree as JMerkleTree
from fisco_bcos_tpu.storage import table as jtable
from fisco_bcos_tpu.storage.interfaces import TwoPCParams as JTwoPCParams
from fisco_bcos_tpu.txpool import TxPool as JTxPool
from fisco_bcos_tpu.txpool.quota import AdmissionQuotas as JAdmissionQuotas
from fisco_bcos_tpu.utils.error import ErrorCode as JErrorCode
from fisco_bcos_tpu_torch import ledger as pledger
from fisco_bcos_tpu_torch import protocol as pprotocol
from fisco_bcos_tpu_torch import storage as pstorage
from fisco_bcos_tpu_torch.codec import flat as pflat
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.ledger import ledger as pledger_mod
from fisco_bcos_tpu_torch.ops import _kernels
from fisco_bcos_tpu_torch.ops.merkle import MerkleTree
from fisco_bcos_tpu_torch.storage import table as ptable
from fisco_bcos_tpu_torch.storage.interfaces import TwoPCParams
from fisco_bcos_tpu_torch.txpool import TxPool, validator
from fisco_bcos_tpu_torch.txpool.quota import AdmissionQuotas
from fisco_bcos_tpu_torch.utils.error import ErrorCode
from test_torch_txpool import quick_sign

SEED = 20_261_019


@dataclass(frozen=True)
class HostLegs(jsuite.CryptoSuite):
    """A JAX suite whose batch hash (and so its address batch) is its
    single-item host hash, a message at a time (its own runs a JAX
    program)."""

    def hash_batch(self, msgs) -> np.ndarray:
        return np.frombuffer(b"".join(map(self.hash, msgs)), dtype=np.uint8).reshape(-1, 32)

    def hash_batch_async(self, msgs):
        out = self.hash_batch(msgs)
        return lambda: out

    def calculate_address_batch(self, pubs) -> np.ndarray:
        return self.hash_batch([bytes(p) for p in np.asarray(pubs)])[:, 12:]


def _host_legs(make):
    s = make()
    return HostLegs(s.hash_impl, s.signature_impl)


PORT = {"ecdsa": psuite.ecdsa_suite(device="cpu"), "sm": psuite.sm_suite(device="cpu")}
JAX = {"ecdsa": _host_legs(jsuite.ecdsa_suite), "sm": _host_legs(jsuite.sm_suite)}
KINDS = sorted(PORT)


@pytest.fixture(autouse=True)
def cpu_only(monkeypatch):
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))


def rows(store) -> list[tuple[str, bytes, dict, int]]:
    return sorted((t, bytes(k), dict(e.fields), int(e.status)) for t, k, e in store.traverse())


@functools.lru_cache(maxsize=None)
def signed_wires(kind: str, n: int, tag: str, block_limit: int = 500) -> tuple[bytes, ...]:
    """n transactions of three seeded signers, as wire bytes (signed once:
    each package's chain decodes the same bytes)."""
    suite = PORT[kind]
    rng = np.random.default_rng([SEED, n, len(tag)])
    kps = [suite.signature_impl.generate_keypair(secret=0x7A00 + i) for i in range(3)]
    out = []
    for i in range(n):
        t = pprotocol.Transaction(
            version=1, chain_id="chain0", group_id="group0", block_limit=block_limit, nonce=f"{tag}{i}",
            to=rng.bytes(20), input=rng.bytes(int(rng.integers(0, 300))), abi="" if i % 2 else '{"a":1}',
            attribute=i % 5, import_time=1_700_000_000_000 + i, extra_data=rng.bytes(i % 3),
        )
        t.signature = quick_sign(kind, kps[i % 3], t.hash(suite), 0x51C0 + n)
        out.append(t.encode())
    return tuple(out)


def receipts(pkg, n: int, number: int) -> list:
    logs = [pkg.LogEntry(address=bytes([7]) * 20, topics=[bytes([i]) * 32 for i in range(2)], data=b"log")]
    return [
        pkg.TransactionReceipt(version=0, gas_used=21_000 + 7 * i, contract_address=b"" if i % 2 else bytes(20),
                               status=15 if i == 2 else 0, output=bytes([i % 256]) * (i % 7),
                               log_entries=logs if i % 2 else [], block_number=number,
                               effective_gas_price="" if i % 3 else "1")
        for i in range(n)
    ]


def header(pkg, number: int, parent: bytes, nodes: list[bytes], **extra):
    return pkg.BlockHeader(
        version=1, parent_info=[pkg.ParentInfo(number - 1, parent)], number=number, gas_used=1000 * number,
        timestamp=1_700_000_000_000 + number, sealer=number % 4, sealer_list=list(nodes),
        consensus_weights=[1, 2, 3, 4], extra_data=b"x" * number, **extra,
    )


def nodes(kind: str) -> list[bytes]:
    return [PORT[kind].signature_impl.generate_keypair(secret=0x4E0D + i).pub for i in range(4)]


def write_chain(kind: str, pkg, led_mod, store_mod, suite, blocks: int = 2):
    """Genesis and `blocks` prewritten blocks into a MemoryStorage; returns
    (store, ledger, the blocks' wire transactions)."""
    store = store_mod.MemoryStorage()
    ledger = led_mod.Ledger(store, suite)
    committee = [
        led_mod.ConsensusNode(pub, weight=i + 1, node_type="consensus_observer" if i == 3 else "consensus_sealer",
                              qc_pub=bytes([i]) * 32 if i % 2 else b"")
        for i, pub in enumerate(nodes(kind))
    ]
    ledger.build_genesis(led_mod.GenesisConfig(consensus_nodes=committee, tx_count_limit=10_240, timestamp=17,
                                               governors=["0xabc", "0xdef"]))
    wires = []
    for number in range(1, blocks + 1):
        w = signed_wires(kind, 3 + 2 * number, f"b{number}-")
        wires.append(w)
        txs = [pkg.Transaction.decode(b) for b in w]
        blk = pkg.Block(header=header(pkg, number, ledger.block_hash_by_number(number - 1), nodes(kind)),
                        transactions=txs, receipts=receipts(pkg, len(txs), number))
        blk.header.txs_root = blk.calculate_txs_root(suite)
        blk.header.receipts_root = blk.calculate_receipts_root(suite)
        overlay = store_mod.StateStorage(prev=store)
        ledger.prewrite_block(blk, overlay)
        ledger.store_code(bytes([number]) * 32, b"\x60\x00" * number, "[]" if number == 1 else "", overlay)
        overlay.merge_into_prev()
    return store, ledger, wires


def test_error_codes_and_statuses_equal_the_jax_package():
    for port, jax_ in ((ErrorCode, JErrorCode), (pprotocol.TransactionStatus, jprotocol.TransactionStatus),
                       (pprotocol.TransactionAttribute, jprotocol.TransactionAttribute)):
        assert {e.name: int(e) for e in port} == {e.name: int(e) for e in jax_}


def test_flat_codec_bytes_equal_the_jax_codec():
    def write(mod):
        w = mod.FlatWriter()
        w.u8(255).u32(2**32 - 1).i64(-(2**63)).u64(2**64 - 1).bytes_(b"\x00\xff").str_("chain0 — 链")
        w.fixed(bytes(range(32)), 32).seq([b"a", b"", b"ccc"], lambda w2, x: w2.bytes_(x))
        return w.out()

    buf = write(pflat)
    assert buf == write(jflat)
    r = pflat.FlatReader(buf)
    got = (r.u8(), r.u32(), r.i64(), r.u64(), r.bytes_(), r.str_(), r.fixed(32), r.seq(lambda r2: r2.bytes_()))
    assert got == (255, 2**32 - 1, -(2**63), 2**64 - 1, b"\x00\xff", "chain0 — 链", bytes(range(32)),
                   [b"a", b"", b"ccc"])
    assert r.at_end()
    r.done()
    for mod in (pflat, jflat):
        with pytest.raises(ValueError):
            mod.FlatReader(b"\x05\x00\x00\x00ab").bytes_()
        with pytest.raises(ValueError):
            mod.FlatReader(b"\x00").done()
        with pytest.raises(ValueError):
            mod.FlatWriter().fixed(b"abc", 4)


@pytest.mark.parametrize("kind", KINDS)
def test_transaction_encodings_and_hashes_equal_the_jax_package(kind):
    """encode_data, encode, decode across the packages, the single and
    batch hashes (the batch fills only empty caches), the signature's
    sender on the host."""
    port, jax_ = PORT[kind], JAX[kind]
    wires = signed_wires(kind, 6, "tx")
    ptxs = [pprotocol.Transaction.decode(b) for b in wires]
    jtxs = [jprotocol.Transaction.decode(b) for b in wires]
    for b, p, j in zip(wires, ptxs, jtxs):
        assert p.encode() == j.encode() == b and p.encode_data() == j.encode_data()
        fresh = pprotocol.Transaction(version=p.version, chain_id=p.chain_id, group_id=p.group_id,
                                      block_limit=p.block_limit, nonce=p.nonce, to=p.to, input=p.input, abi=p.abi,
                                      signature=p.signature, attribute=p.attribute, import_time=p.import_time,
                                      extra_data=p.extra_data)
        assert fresh.encode() == b and fresh.sender == b""
    ptxs[1].hash(port)  # a cached hash the batch keeps
    ptxs[2]._hash = b"\x11" * 32  # so that a stale cache shows
    got = pprotocol.transaction.hash_transactions_batch(ptxs, port)
    want = jprotocol.transaction.hash_transactions_batch(jtxs, jax_)
    assert got[2] == b"\x11" * 32
    assert got[:2] + got[3:] == want[:2] + want[3:] == [jax_.hash(t.encode_data()) for t in jtxs[:2] + jtxs[3:]]
    for p, j in zip(ptxs[3:], jtxs[3:]):
        assert p.verify(port) and j.verify(jax_) and p.sender == j.sender
    p = ptxs[0]
    p.nonce = "changed"
    p.invalidate_caches()
    assert p.encode_data() != jtxs[0].encode_data() and p._hash is None


@pytest.mark.parametrize("kind", KINDS)
def test_receipt_header_and_block_encodings_equal_the_jax_package(kind):
    port, jax_ = PORT[kind], JAX[kind]
    prc, jrc = receipts(pprotocol, 4, 9), receipts(jprotocol, 4, 9)
    for p, j in zip(prc, jrc):
        assert p.encode() == j.encode()
        assert p.hash(port) == j.hash(jax_)
        assert pprotocol.TransactionReceipt.decode(j.encode()).encode() == j.encode()
    ns = nodes(kind)
    for extra in ({}, {"qc": b"\x01" * 40, "state_commitment": b"\x02" * 32}):
        ph, jh = header(pprotocol, 5, b"\x33" * 32, ns, **extra), header(jprotocol, 5, b"\x33" * 32, ns, **extra)
        ph.signature_list = [pprotocol.SignatureTuple(1, b"sig1"), pprotocol.SignatureTuple(3, b"sig3")]
        jh.signature_list = [jprotocol.SignatureTuple(1, b"sig1"), jprotocol.SignatureTuple(3, b"sig3")]
        assert ph.encode_hash_fields() == jh.encode_hash_fields() and ph.encode() == jh.encode()
        assert ph.hash(port) == jh.hash(jax_)
        back = pprotocol.BlockHeader.decode(jh.encode())
        assert back.encode() == jh.encode() and back.qc == jh.qc and back.hash(port) == jh.hash(jax_)
    wires = signed_wires(kind, 3, "blk")
    pb = pprotocol.Block(header=ph, transactions=[pprotocol.Transaction.decode(b) for b in wires], receipts=prc[:3],
                         tx_metadata=[b"\x44" * 32])
    jb = jprotocol.Block(header=jh, transactions=[jprotocol.Transaction.decode(b) for b in wires], receipts=jrc[:3],
                         tx_metadata=[b"\x44" * 32])
    assert pb.encode() == jb.encode()
    assert pprotocol.Block.decode(jb.encode()).encode() == jb.encode()
    view = pprotocol.Block.execution_view(jb.encode(), pb.transactions)
    assert view.header.encode() == jh.encode() and view.transactions == pb.transactions and view.number == 5
    assert pb.tx_hashes(port) == jb.tx_hashes(jax_)
    assert pprotocol.Block(tx_metadata=[b"\x55" * 32]).tx_hashes(port) == [b"\x55" * 32]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0, 1, 17, 300])
def test_txs_and_receipts_roots_equal_the_jax_package(kind, n):
    """Block.calculate_txs_root and calculate_receipts_root over n leaves;
    the tx leaves are hashes given as metadata, as a proposal carries them."""
    port, jax_ = PORT[kind], JAX[kind]
    rng = np.random.default_rng([SEED, n])
    meta = [rng.bytes(32) for _ in range(n)]
    prc, jrc = receipts(pprotocol, n, 3), receipts(jprotocol, n, 3)
    pb, jb = pprotocol.Block(tx_metadata=meta, receipts=prc), jprotocol.Block(tx_metadata=meta, receipts=jrc)
    assert pb.calculate_txs_root(port) == jb.calculate_txs_root(jax_)
    assert pb.calculate_receipts_root(port) == jb.calculate_receipts_root(jax_)
    if n == 0:
        assert pb.calculate_txs_root(port) == pb.calculate_receipts_root(port) == bytes(32)


@pytest.mark.parametrize("kind", KINDS)
def test_ledger_rows_after_genesis_and_two_blocks_equal_the_jax_ledger(kind):
    """Every row, through traverse(); the queries; the proofs against each
    block's roots."""
    port, jax_ = PORT[kind], JAX[kind]
    pstore, pled, wires = write_chain(kind, pprotocol, pledger, pstorage, port)
    jstore, jled, _ = write_chain(kind, jprotocol, jledger, jstorage, jax_)
    assert rows(pstore) == rows(jstore)
    assert (pled.block_number(), pled.total_transaction_count(), pled.total_failed_transaction_count()) == (
        jled.block_number(), jled.total_transaction_count(), jled.total_failed_transaction_count()) == (2, 12, 2)
    pc, jc = pled.ledger_config(), jled.ledger_config()
    assert {**vars(pc), "consensus_nodes": [vars(n) for n in pc.consensus_nodes]} == {
        **vars(jc), "consensus_nodes": [vars(n) for n in jc.consensus_nodes]}
    assert pc.tx_count_limit == 10_240 and len(pc.consensus_nodes) == 4
    assert pled.system_config(b"auth_governors") == jled.system_config(b"auth_governors") == ("0xabc,0xdef", 0)
    assert pled.build_genesis(pledger.GenesisConfig()).encode() == pled.header_by_number(0).encode()
    for number in range(3):
        blk, jblk = pled.block_by_number(number, with_receipts=True), jled.block_by_number(number, with_receipts=True)
        assert blk.encode() == jblk.encode()
        assert pled.nonces_by_number(number) == jled.nonces_by_number(number)
        assert pled.block_number_by_hash(pled.block_hash_by_number(number)) == number
    for number, ws in enumerate(wires, start=1):
        head = pled.header_by_number(number)
        for i in (0, len(ws) - 1):
            h = port.hash(pprotocol.Transaction.decode(ws[i]).encode_data())
            assert pled.tx_by_hash(h).encode() == ws[i]
            for proof, jproof, root, leaf in (
                (pled.tx_proof(h), jled.tx_proof(h), head.txs_root, h),
                (pled.receipt_proof(h), jled.receipt_proof(h), head.receipts_root,
                 pled.receipt_by_hash(h).hash(port)),
            ):
                items, idx, n = proof
                assert [(it.group, it.index) for it in items] == [(it.group, it.index) for it in jproof[0]]
                assert (idx, n) == jproof[1:] == (i, len(ws))
                hasher = port.hash_impl.name
                assert MerkleTree.verify_proof(leaf, idx, n, items, root, hasher=hasher)
                assert JMerkleTree.verify_proof(leaf, idx, n, jproof[0], root, hasher=hasher)
    assert pled.proof_batch_direct([b"\x00" * 32]) == [None]
    assert pled.tx_proof(b"\x00" * 32) is None


@pytest.mark.parametrize("kind", KINDS)
def test_state_storage_hash_and_merges_equal_the_jax_overlay(kind):
    """Reads through layers, deletes, primary keys, the XOR state hash, and
    merge_into_prev onto an overlay (entries move) and onto a backend."""
    port, jax_ = PORT[kind], JAX[kind]
    out = []
    for mod, suite in ((pstorage, port), (jstorage, jax_)):
        base = mod.MemoryStorage()
        for i in range(6):
            base.set_row("t0", b"k%d" % i, mod.Entry().set(b"base%d" % i))
        mid = mod.StateStorage(prev=base)
        top = mod.StateStorage(prev=mid)
        for i in range(9):
            top.set_row(f"t{i % 2}", b"k%d" % i, mod.Entry({"value": b"v%d" % i, "extra": bytes(i)}))
        top.remove_row("t0", b"k0")
        mid.set_row("t0", b"k5", mod.Entry().set(b"mid5"))
        state = (top.hash(suite), top.dirty_count(), top.get_primary_keys("t0"), top.get_row("t0", b"k0"),
                 top.get_row("t0", b"k5").encode(), mod.StateStorage().hash(suite))
        top.merge_into_prev()
        mid_hash = mid.hash(suite)
        mid.merge_into_prev()
        out.append((state, mid_hash, rows(base), top.dirty_count(), mid.dirty_count()))
    assert out[0] == out[1]
    assert out[0][0][0] != bytes(32) and out[0][0][5] == bytes(32)


def test_sqlite_two_phase_commit_and_tables_equal_the_jax_backend(tmp_path):
    out = []
    for mod, tbl, params in ((pstorage, ptable, TwoPCParams), (jstorage, jtable, JTwoPCParams)):
        db = mod.SQLiteStorage(str(tmp_path / f"{mod.__name__}.db"))
        t = tbl.create_table(db, "t_users", "name", ("balance", "note"))
        with pytest.raises(ValueError):
            tbl.create_table(db, "t_users")
        t.set_row(b"alice", mod.Entry({"balance": b"10", "note": b"n"}))
        db.set_rows("kv", [(b"a", mod.Entry().set(b"1")), (b"b", mod.Entry().set(b"2"))])
        writes = mod.StateStorage()
        writes.set_row("kv", b"c", mod.Entry().set(b"3"))
        writes.remove_row("kv", b"a")
        db.prepare(params(number=7), writes)
        db.prepare(params(number=8), writes)
        pending = db.pending_numbers()
        db.commit(params(number=7))
        db.rollback(params(number=8))
        opened = tbl.open_table(db, "t_users")
        opened.remove(b"alice")
        out.append((pending, db.pending_numbers(), rows(db), db.get_primary_keys("kv"), db.get_row("kv", b"a"),
                    opened.info, tbl.open_table(db, "missing"), db.bytes_staged, db.bytes_written))
        db.close()
    port_out, jax_out = out
    assert port_out[:5] == jax_out[:5] and port_out[7:] == jax_out[7:]
    assert vars(port_out[5]) == vars(jax_out[5]) and port_out[6] is jax_out[6] is None
    assert port_out[0] == [7, 8] and port_out[3] == [b"b", b"c"]


@pytest.mark.parametrize("kind", KINDS)
def test_memory_storage_from_rows_reads_a_jax_written_chain(kind):
    """A chain the JAX ledger wrote, carried across as plain tuples: the
    port's ledger reads the same headers, hashes, transactions and nonces,
    and the port's pool primes the same replay window, rejecting a replay
    with no device batch."""
    port, jax_ = PORT[kind], JAX[kind]
    jstore, jled, wires = write_chain(kind, jprotocol, jledger, jstorage, jax_)
    jstore.set_row("t_gone", b"k", jstorage.Entry(status=jstorage.EntryStatus.DELETED))
    carried = [(t, k, dict(e.fields), int(e.status)) for t, k, e in jstore.traverse()]
    store = pstorage.MemoryStorage.from_rows(carried)
    assert rows(store) == rows(jstore) and store.get_row("t_gone", b"k") is None
    led = pledger.Ledger(store, port)
    assert led.block_number() == jled.block_number() == 2
    for number in range(3):
        assert led.header_by_number(number).encode() == jled.header_by_number(number).encode()
        assert led.block_hash_by_number(number) == jled.block_hash_by_number(number)
        assert led.header_by_number(number).hash(port) == led.block_hash_by_number(number)
        assert led.tx_hashes_by_number(number) == jled.tx_hashes_by_number(number)
        assert [t.encode() for t in led.block_by_number(number).transactions] == [
            t.encode() for t in jled.block_by_number(number).transactions]
        assert led.nonces_by_number(number) == jled.nonces_by_number(number)
    assert [vars(n) for n in led.consensus_nodes()] == [vars(n) for n in jled.consensus_nodes()]
    batches = []
    with pytest.MonkeyPatch.context() as mp:
        for key in validator._FUSED:
            mp.setitem(validator._FUSED, key, lambda *a, **k: batches.append(a) or pytest.fail("device batch"))
        pool = TxPool(port, led, quotas=AdmissionQuotas())
        replay = pool.submit_batch([pprotocol.Transaction.decode(b) for b in wires[1][:3]])
    jpool = JTxPool(jax_, jled, quotas=JAdmissionQuotas())
    jreplay = jpool.submit_batch([jprotocol.Transaction.decode(b) for b in wires[1][:3]])
    assert (pool.ledger_nonces._block_number, pool.ledger_nonces._nonces) == (
        jpool.ledger_nonces._block_number, jpool.ledger_nonces._nonces)
    assert [(r.tx_hash, int(r.status), r.sender) for r in replay] == [
        (r.tx_hash, int(r.status), r.sender) for r in jreplay]
    assert {r.status for r in replay} == {ErrorCode.TX_ALREADY_IN_CHAIN} and not batches


def test_ledger_module_constants_equal_the_jax_ledger():
    names = [n for n in vars(jledger_mod) if n.startswith(("SYS_", "KEY_", "CONFIG_")) or n == "SYSTEM_TABLES"]
    assert len(names) > 15
    assert {n: getattr(pledger_mod, n) for n in names} == {n: getattr(jledger_mod, n) for n in names}
    nodes_ = [pledger.ConsensusNode(b"\x01" * 64, 3, "consensus_observer", 5, b"q" * 48)]
    jnodes = [jledger.ConsensusNode(b"\x01" * 64, 3, "consensus_observer", 5, b"q" * 48)]
    assert pledger_mod._encode_nodes(nodes_) == jledger_mod._encode_nodes(jnodes)
    old = jflat.FlatWriter().seq(jnodes, lambda w, n: (w.bytes_(n.node_id), w.u64(n.weight), w.str_(n.node_type),
                                                        w.i64(n.enable_number))).out()
    assert [vars(n) for n in pledger_mod._decode_nodes(old)] == [vars(n) for n in jledger_mod._decode_nodes(old)]
