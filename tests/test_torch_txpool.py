"""The port's transaction pool (``fisco_bcos_tpu_torch/txpool``) against the
JAX package's, on the CPU, for the ECDSA and the SM suite.

One scenario runs in both packages on the same transactions. Each
transaction is built once from a numpy seed, signed on the host (one nonce
a suite: ``quick_sign``) and encoded;
each package decodes its own copy from those wire bytes, so no sender is
pre-filled and the device's senders are what the pools hold. The JAX pool
runs on the JAX suite's host legs (its native signature loop; batch hashes a
message at a time, as tests/test_torch_node_seam.py's ``HostLegs``), so no
JAX program is traced; the port's runs on ``ecdsa_suite(device="cpu")`` /
``sm_suite(device="cpu")``, its plain PyTorch versions. The scenario:

1. genesis of a four-node committee; a pool with a durable sqlite store, a
   pool limit and a group quota that fund only part of the first batch, and
   one strike to demotion;
2. a 32-transaction batch with every rejected kind: bad signatures (an
   invalid v or r = 0, a short signature, a flipped bit), intra-batch nonce
   repeats, a wrong chain and group, block limits expired and too far ahead,
   the pool full, the quota's prefix grant; then the demoted source's batch
   and a batch of pooled nonces, neither launching anything;
3. three blocks: ``seal_txs`` over the senders (one ``unseal`` between),
   a proposal naming transactions the pool lacks with no fetch, each block's
   txs and receipts roots, ``Ledger.prewrite_block`` into an overlay, its
   state hash, ``merge_into_prev`` and ``on_block_committed``;
4. replays of committed transactions and an expired one (no launch);
5. (ECDSA) a second pool over the same sqlite store reloads it
   (``reload_persisted``) while the first pool verifies a proposal of its
   last transactions and two it never saw (``verify_block`` with a
   straggler fetch, on the consensus lane), ``mark_sealed`` after. The
   port's DevicePlane merges the two ``batch_admit`` calls into one
   dispatch; the reload reads the store before it, the fetch writes after
   it, so the JAX pools, run one after the other, see the same store.

Every result, order, root, hash and row is compared between the packages,
and against the expectation built with the transactions. The port's device
work is counted: the admission body runs once for the mixed batch and once
for step 5 (a plain EC batch costs seconds on the CPU whatever its lanes)."""

from __future__ import annotations

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import pytest

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.ledger import ConsensusNode as JConsensusNode
from fisco_bcos_tpu.ledger import GenesisConfig as JGenesisConfig
from fisco_bcos_tpu.ledger import Ledger as JLedger
from fisco_bcos_tpu.protocol import Block as JBlock
from fisco_bcos_tpu.protocol import BlockHeader as JBlockHeader
from fisco_bcos_tpu.protocol import ParentInfo as JParentInfo
from fisco_bcos_tpu.protocol import Transaction as JTransaction
from fisco_bcos_tpu.protocol import TransactionReceipt as JTransactionReceipt
from fisco_bcos_tpu.storage import MemoryStorage as JMemoryStorage
from fisco_bcos_tpu.storage import SQLiteStorage as JSQLiteStorage
from fisco_bcos_tpu.storage import StateStorage as JStateStorage
from fisco_bcos_tpu.txpool import TxPool as JTxPool
from fisco_bcos_tpu.txpool.quota import AdmissionQuotas as JAdmissionQuotas
from fisco_bcos_tpu_torch.crypto import admission
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.device.plane import DevicePlane
from fisco_bcos_tpu_torch.ledger import ConsensusNode, GenesisConfig, Ledger
from fisco_bcos_tpu_torch.ops import _kernels
from fisco_bcos_tpu_torch.protocol import Block, BlockHeader, ParentInfo, Transaction, TransactionReceipt
from fisco_bcos_tpu_torch.storage import MemoryStorage, SQLiteStorage, StateStorage
from fisco_bcos_tpu_torch.txpool import TxPool
from fisco_bcos_tpu_torch.txpool.quota import AdmissionQuotas
from fisco_bcos_tpu_torch.utils.error import ErrorCode

SEED = 20_261_018
POOL_LIMIT = 24  # room for 24 of the batch's 26 admissible transactions
GRANT = 20  # the group quota funds the first 20 of them
SEAL = (6, 6, 3)  # transactions sealed into blocks 1-3
SELECTOR = bytes.fromhex("a9059cbb")  # transfer(address,uint256)
# Suites whose scenario ends with step 5 (a straggler fetch and a reload,
# one more device batch). A plain SM2 batch costs ~8 s on the CPU, so the SM
# scenario's one device batch is its mixed batch: that is the suite's branch
# of batch_admit, the one call the fetch and the reload also make.
FULL = ("ecdsa",)


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


SUITES = {
    "ecdsa": (psuite.ecdsa_suite, jsuite.ecdsa_suite),
    "sm": (psuite.sm_suite, jsuite.sm_suite),
}


@functools.lru_cache(maxsize=None)
def _nonce_point(kind: str, k: int) -> tuple[int, int]:
    c = ref.SECP256K1 if kind == "ecdsa" else ref.SM2_CURVE
    return ref.point_mul(c, k, (c.gx, c.gy))


def quick_sign(kind: str, kp, msg_hash: bytes, k: int) -> bytes:
    """A valid signature of `msg_hash` (65-byte r ‖ s ‖ v, or SM2's 128-byte
    r ‖ s ‖ pub) under a nonce `k` that a test's transactions share: test
    data only, a few modular products each instead of a point
    multiplication."""
    x, y = _nonce_point(kind, k)
    if kind == "ecdsa":
        n = ref.SECP256K1.n
        if x >= n:
            raise ValueError("choose another k: R.x >= n")
        s = pow(k, -1, n) * (int.from_bytes(msg_hash, "big") + x * kp.secret) % n
        return x.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([y & 1])
    n = ref.SM2_CURVE.n
    r = (ref.sm2_e(msg_hash, (kp.pub_x, kp.pub_y)) + x) % n
    s = pow(1 + kp.secret, -1, n) * (k - r * kp.secret) % n
    if not r or r + k == n or not s:
        raise ValueError("choose another k: a degenerate SM2 signature")
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + kp.pub


def transfer_input(to: bytes, amount: int) -> bytes:
    """A 68-byte transfer call: selector, the address word, the amount word."""
    return SELECTOR + to.rjust(32, b"\0") + amount.to_bytes(32, "big")


class Wire:
    """The scenario's transactions as wire bytes, with what each should give."""

    def __init__(self, kind: str):
        self.kind = kind
        self.suite = SUITES[kind][0](device="cpu")
        rng = np.random.default_rng(SEED + (kind == "sm"))
        self.rng = rng
        self.k = int(rng.integers(1, 1 << 62))
        sig = self.suite.signature_impl
        self.users = [sig.generate_keypair(secret=int(rng.integers(1, 1 << 62))) for _ in range(4)]
        self.addrs = [self.suite.calculate_address(kp.pub) for kp in self.users]
        self.nodes = [sig.generate_keypair(secret=0x4E0D + i).pub for i in range(4)]

    def tx(self, user: int, *, nonce: str | None = None, block_limit: int = 100, chain_id: str = "chain0",
           group_id: str = "group0", corrupt: str | None = None) -> bytes:
        rng = self.rng
        to = rng.bytes(20)
        t = Transaction(
            version=1, chain_id=chain_id, group_id=group_id, block_limit=block_limit,
            nonce=nonce if nonce is not None else f"{int(rng.integers(1 << 62)):x}",
            to=to, input=transfer_input(to, int(rng.integers(1, 1 << 40))),
            import_time=1_700_000_000_000 + int(rng.integers(1 << 20)),
        )
        sig = bytearray(quick_sign(self.kind, self.users[user], t.hash(self.suite), self.k))
        if corrupt == "v":  # ECDSA: a v no device accepts; SM2: s one bit off
            if self.kind == "ecdsa":
                sig[64] = 7
            else:
                sig[40] ^= 1
        elif corrupt == "r0":
            sig[:32] = bytes(32)
        elif corrupt == "short":
            sig = sig[:-1]
        elif corrupt == "flip":  # ECDSA: recovers another key; SM2: another signer's key
            if self.kind == "ecdsa":
                sig[63] ^= 1
            else:
                sig[64:] = self.users[(user + 1) % 4].pub
        t.signature = bytes(sig)
        return t.encode()

    def hash(self, wire: bytes) -> bytes:
        return self.suite.hash(Transaction.decode(wire).encode_data())


def mixed_batch(w: Wire) -> tuple[list[bytes], list[ErrorCode]]:
    """The 32-lane batch of step 2 and the status each lane should get."""
    txs = [w.tx(i % 3) for i in range(16)]  # lanes 0-15: three senders
    want = [ErrorCode.SUCCESS] * 16
    for corrupt in ("v", "r0", "short"):  # lanes 16-18
        txs.append(w.tx(0, corrupt=corrupt))
        want.append(ErrorCode.INVALID_SIGNATURE)
    txs.append(w.tx(1, corrupt="flip"))  # lane 19
    want.append(ErrorCode.SUCCESS if w.kind == "ecdsa" else ErrorCode.INVALID_SIGNATURE)
    for lane in (0, 5):  # lanes 20-21: nonces of lanes 0 and 5 again
        txs.append(w.tx(2, nonce=Transaction.decode(txs[lane]).nonce))
        want.append(ErrorCode.ALREADY_IN_TX_POOL)
    txs += [w.tx(0, chain_id="chain1"), w.tx(0, group_id="group1")]  # lanes 22-23
    want += [ErrorCode.INVALID_CHAIN_ID, ErrorCode.INVALID_GROUP_ID]
    txs += [w.tx(1, block_limit=0), w.tx(1, block_limit=601)]  # lanes 24-25: head 0, window 600
    want += [ErrorCode.BLOCK_LIMIT_CHECK_FAIL] * 2
    txs += [w.tx(3) for _ in range(6)]  # lanes 26-31: admissible, over the quota or the pool
    want += [ErrorCode.OVER_GROUP_QUOTA] * 4 + [ErrorCode.TX_POOL_FULL] * 2
    return txs, want


class Package:
    """One package's classes, and its suite for the scenario."""

    def __init__(self, port: bool, kind: str):
        self.port = port
        if port:
            self.suite = SUITES[kind][0](device="cpu")
            self.Tx, self.Block, self.Header, self.Parent, self.Receipt = (
                Transaction, Block, BlockHeader, ParentInfo, TransactionReceipt)
            self.Memory, self.SQLite, self.State, self.Ledger, self.Pool, self.Quotas = (
                MemoryStorage, SQLiteStorage, StateStorage, Ledger, TxPool, AdmissionQuotas)
            self.Genesis, self.Node = GenesisConfig, ConsensusNode
        else:
            jax_suite = SUITES[kind][1]()
            self.suite = HostLegs(jax_suite.hash_impl, jax_suite.signature_impl)
            self.Tx, self.Block, self.Header, self.Parent, self.Receipt = (
                JTransaction, JBlock, JBlockHeader, JParentInfo, JTransactionReceipt)
            self.Memory, self.SQLite, self.State, self.Ledger, self.Pool, self.Quotas = (
                JMemoryStorage, JSQLiteStorage, JStateStorage, JLedger, JTxPool, JAdmissionQuotas)
            self.Genesis, self.Node = JGenesisConfig, JConsensusNode

    def decode(self, wires):
        return [self.Tx.decode(b) for b in wires]


def results(rs) -> list[tuple[bytes, int, bytes]]:
    return [(r.tx_hash, int(r.status), r.sender) for r in rs]


def rows(store) -> list[tuple[str, bytes, dict, int]]:
    return sorted((t, bytes(k), dict(e.fields), int(e.status)) for t, k, e in store.traverse())


def run_scenario(pkg: Package, w: Wire, batch: list[bytes], extra: dict, path) -> dict:
    """Steps 1-5 in one package; what each step gave, as plain values."""
    out: dict = {}
    suite = pkg.suite
    store = pkg.Memory()
    ledger = pkg.Ledger(store, suite)
    genesis = ledger.build_genesis(pkg.Genesis(
        consensus_nodes=[pkg.Node(pub) for pub in w.nodes], tx_count_limit=sum(SEAL), timestamp=1_700_000_000_000,
    ))
    out["genesis"] = genesis.hash(suite)
    quotas = pkg.Quotas(strike_limit=1, demote_s=600.0)
    quotas.configure("group0", rate=1e-9, burst=GRANT)
    pstore = pkg.SQLite(str(path / ("port.db" if pkg.port else "jax.db")))
    pool = pkg.Pool(suite, ledger, pool_limit=POOL_LIMIT, persistent_store=pstore, quotas=quotas)

    out["mixed"] = results(pool.submit_batch(pkg.decode(batch), source="spammer"))
    out["demoted"] = results(pool.submit_batch(pkg.decode(batch[26:30]), source="spammer"))
    out["pooled"] = results(pool.submit_batch(pkg.decode(batch[:4]), source="rpc"))
    out["quotas"] = quotas.snapshot()

    stragglers = {w.hash(b): t for b, t in zip(extra["stragglers"], pkg.decode(extra["stragglers"]))}
    out["stragglers"] = list(stragglers)
    out["verify_unfetched"] = pool.verify_block(list(stragglers))
    out["seal"], out["senders"], out["roots"], out["state"] = [], [], [], []
    for number, limit in enumerate(SEAL, start=1):
        if number == 2:  # sealed, then returned to the tail of the sealable order
            _, back = pool.seal_txs(3)
            pool.unseal(back)
        txs, hashes = pool.seal_txs(limit)
        out["seal"].append(hashes)
        out["senders"].append([t.sender for t in txs])
        receipts = [
            pkg.Receipt(version=0, gas_used=21_000 + i, status=16 if i == 1 else 0, output=bytes([i]) * i,
                        block_number=number)
            for i in range(len(txs))
        ]
        block = pkg.Block(
            header=pkg.Header(
                version=1, parent_info=[pkg.Parent(number - 1, ledger.block_hash_by_number(number - 1))],
                number=number, gas_used=sum(r.gas_used for r in receipts), timestamp=1_700_000_000_000 + number,
                sealer=number % 4, sealer_list=list(w.nodes), consensus_weights=[1] * 4,
            ),
            transactions=txs, receipts=receipts,
        )
        block.header.txs_root = block.calculate_txs_root(suite)
        block.header.receipts_root = block.calculate_receipts_root(suite)
        overlay = pkg.State(prev=store)
        ledger.prewrite_block(block, overlay)
        out["roots"].append((block.header.txs_root, block.header.receipts_root, block.header.hash(suite)))
        out["state"].append(overlay.hash(suite))
        overlay.merge_into_prev()
        pool.on_block_committed(number, hashes)
    out["after"] = results(pool.submit_batch(pkg.decode(extra["after"]), source="rpc"))
    out["pending"] = (pool.pending_count(), pool.unsealed_count())
    out["chain"] = rows(store)
    out["ledger"] = (ledger.block_number(), ledger.total_transaction_count(), ledger.total_failed_transaction_count(),
                     [ledger.nonces_by_number(n) for n in range(4)])
    out["pstore"] = rows(pstore)

    if w.kind in FULL:  # step 5
        reloaded = pkg.Pool(suite, ledger, pool_limit=POOL_LIMIT, persistent_store=pstore, quotas=pkg.Quotas())
        _, last = pool.seal_txs(POOL_LIMIT)
        proposal = last + list(stragglers)

        def verify():
            return pool.verify_block(proposal, fetch_missing=lambda miss: [stragglers.get(h) for h in miss])

        if pkg.port:
            with merging_plane(len(last) + len(stragglers)), ThreadPoolExecutor(2) as ex:
                reload_done, verify_done = ex.submit(reloaded.reload_persisted), ex.submit(verify)
                out["reload"], out["verify"] = reload_done.result(), verify_done.result()
        else:
            out["reload"], out["verify"] = reloaded.reload_persisted(), verify()
        pool.mark_sealed(proposal)
        out["proposal"] = proposal
        out["fetched"] = [(h, pool.get(h).sender) for h in stragglers]
        out["pending_after"] = (pool.pending_count(), pool.unsealed_count())
        out["reloaded"] = sorted((h, t.sender) for h, t in reloaded._txs.items())
        out["window"] = (reloaded.ledger_nonces._block_number, sorted(reloaded.ledger_nonces._nonces))
        out["pstore_after"] = rows(pstore)
    pstore.close()
    return out


@contextlib.contextmanager
def merging_plane(lanes: int):
    """A DevicePlane that holds requests until `lanes` items are queued, so
    concurrent admissions merge into one dispatch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plane_mod, "_PLANE", DevicePlane(window_ms=60_000, high_water=lanes))
        yield


_SCENARIOS: dict = {}


def run_both(kind: str, tmp_path_factory):
    """The scenario in both packages (once a suite), and the lanes of each
    run of the port's admission body."""
    if kind not in _SCENARIOS:
        _SCENARIOS[kind] = _run_both(kind, tmp_path_factory)
    return _SCENARIOS[kind]


@pytest.fixture(scope="module", params=sorted(SUITES))
def scenario(request, tmp_path_factory):
    return run_both(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def full_scenario(tmp_path_factory):
    """The scenario of a suite that runs step 5."""
    return run_both(FULL[0], tmp_path_factory)


def _run_both(kind: str, tmp_path_factory):
    w = Wire(kind)
    batch, want = mixed_batch(w)
    extra = {
        "stragglers": [w.tx(2), w.tx(0)],
        "after": [batch[0], batch[7], w.tx(1, block_limit=3), w.tx(1, block_limit=604)],
    }
    path = tmp_path_factory.mktemp(f"txpool_{kind}")
    bodies = []  # lanes of each run of the port's admission body
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        for name in ("_admit_direct", "_admit_sm_direct"):
            def counted(payloads, sigs, dev, *args, body=getattr(admission, name), **kwargs):
                bodies.append(len(payloads))
                return body(payloads, sigs, dev, *args, **kwargs)

            mp.setattr(admission, name, counted)
        port = run_scenario(Package(True, kind), w, batch, extra, path)
    jax = run_scenario(Package(False, kind), w, batch, extra, path)
    return w, batch, want, port, jax, bodies


def left(out: dict) -> int:
    """Transactions the mixed batch admitted that the three blocks left."""
    return sum(s == ErrorCode.SUCCESS for _, s, _ in out["mixed"]) - sum(SEAL)


def test_submit_batch_results_equal_the_jax_pool(scenario):
    """Every TxSubmitResult of the mixed batch, byte for byte, and each
    status the expected one; ok lanes carry their signer's address."""
    w, batch, want, port, jax, _ = scenario
    assert port["mixed"] == jax["mixed"]
    assert [s for _, s, _ in port["mixed"]] == [int(c) for c in want]
    for i, (h, status, sender) in enumerate(port["mixed"]):
        assert h == w.hash(batch[i])
        if status == ErrorCode.SUCCESS and i < 16:
            assert sender == w.addrs[i % 3]
        elif status == ErrorCode.SUCCESS:  # the flipped bit recovered another key
            assert len(sender) == 20 and sender not in w.addrs
        else:
            assert sender == b""


def test_demoted_source_and_pooled_nonces_launch_nothing(scenario):
    w, _, _, port, jax, bodies = scenario
    assert port["demoted"] == jax["demoted"] == [(b"", int(ErrorCode.SOURCE_DEMOTED), b"")] * 4
    assert port["pooled"] == jax["pooled"]
    assert {s for _, s, _ in port["pooled"]} == {int(ErrorCode.ALREADY_IN_TX_POOL)}
    assert port["quotas"] == jax["quotas"]
    assert port["quotas"]["group0"]["demoted_sources"] == ["spammer"]
    # the mixed batch's funded lanes; then step 5's fetch and reload merged into one run
    assert bodies == ([GRANT, 2 + left(port)] if w.kind in FULL else [GRANT])


def test_sealing_order_equals_the_jax_pool(scenario):
    """seal_txs' round-robin over the senders (with an unseal between), and
    a proposal naming transactions the pool lacks, with no fetch."""
    _, _, _, port, jax, _ = scenario
    assert port["seal"] == jax["seal"]
    assert [len(hs) for hs in port["seal"]] == list(SEAL)
    assert port["verify_unfetched"] == jax["verify_unfetched"] == (False, port["stragglers"])
    assert port["senders"] == jax["senders"]
    assert {s for ss in port["senders"] for s in ss} <= {s for _, st, s in port["mixed"] if st == 0}


def test_blocks_roots_and_state_hashes_equal_the_jax_ledger(scenario):
    """Each block's txs and receipts roots, header hash and overlay state
    hash; the chain's rows after three blocks, row for row."""
    _, _, _, port, jax, _ = scenario
    assert port["genesis"] == jax["genesis"]
    assert port["roots"] == jax["roots"]
    assert port["state"] == jax["state"]
    assert all(s != bytes(32) for s in port["state"])
    assert port["ledger"] == jax["ledger"]
    assert port["ledger"][:3] == (3, sum(SEAL), 3)
    assert port["chain"] == jax["chain"]


def test_replay_and_expiry_after_commit(scenario):
    _, _, _, port, jax, _ = scenario
    assert port["after"] == jax["after"]
    assert [s for _, s, _ in port["after"]] == [
        int(ErrorCode.TX_ALREADY_IN_CHAIN), int(ErrorCode.TX_ALREADY_IN_CHAIN),
        int(ErrorCode.BLOCK_LIMIT_CHECK_FAIL), int(ErrorCode.BLOCK_LIMIT_CHECK_FAIL),
    ]
    assert port["pending"] == jax["pending"] == (left(port), left(port))
    assert port["pstore"] == jax["pstore"]


def test_verify_block_fetches_stragglers_as_the_jax_pool(full_scenario):
    """The proposal names the pool's last transactions and two it never
    saw: fetched, verified on the consensus lane, inserted, marked sealed."""
    w, _, _, port, jax, _ = full_scenario
    assert port["verify"] == jax["verify"] == (True, [])
    assert port["proposal"] == jax["proposal"] and port["proposal"][-2:] == port["stragglers"]
    assert port["fetched"] == jax["fetched"] == list(zip(port["stragglers"], [w.addrs[2], w.addrs[0]]))
    assert port["pending_after"] == jax["pending_after"] == (left(port) + 2, 0)


def test_reload_persisted_equals_the_jax_pool(full_scenario):
    """A second pool over the same sqlite store re-admits the txs left
    unsealed, with the replay window primed from the chain head."""
    _, _, _, port, jax, _ = full_scenario
    assert port["reload"] == jax["reload"] == left(port) > 0
    assert port["reloaded"] == jax["reloaded"]
    assert port["window"] == jax["window"]
    assert port["window"][0] == 3
    assert port["pstore_after"] == jax["pstore_after"]
