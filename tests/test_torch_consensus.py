"""PBFT consensus of the port (``fisco_bcos_tpu_torch/consensus``) against the
JAX package's, on the CPU: a four-replica committee of each package, over
its own ``InprocGateway``, driven the same way with the same keys, the same
transactions and the same clock.

Each replica holds its own ``Ledger`` over a ``MemoryStorage`` genesis, its
own ``TxPool``, a ``PBFTEngine`` with a ``ConsensusStorage`` over that store
and a ``Sealer``. Execution ends at ``chip_smoke.StandIn`` (the drivers'
stand-in, as the JAX package's own consensus harness keeps its stub): it
executes nothing, returns the proposal's header, and commits a block by
writing it through the package's ``Ledger``; it goes when the scheduler is
ported. The JAX committee runs on the JAX suite's host legs (``HostLegs``:
its native signature loop, batch hashes a message at a time), so no JAX
program is traced; the port's runs on ``ecdsa_suite(device="cpu")``, the
plain PyTorch versions of its kernels.

The scenario, inline dispatch (``InprocGateway(auto=True)``) unless named:

1. 8 transactions (blocks of 3, 3 and 2) go into every replica's pool:
   the four ``submit_batch`` calls run together and each package's
   DevicePlane merges them into one admission batch (a plain EC batch costs
   seconds on the CPU whatever its lanes). A fresh pipeline recorder of
   each package takes the step's stages: the pools' ``admission`` busy, its
   waits blocked on ``device_plane``, the plane's one ``device_plane``
   dispatch.
2. Height 1 with the Ed25519 QC (``FISCO_QC_SCHEME=ed25519``, the default):
   pre-prepare, the prepare, commit and checkpoint quorums, each admitted by
   one aggregate check, and the stable commit that stamps the header's QC
   record. The port's QC scheme runs the port's ``Ed25519Crypto`` on the
   CPU, every vote the JAX committee checked checked once in one plain
   batch, each certificate answered from those verdicts
   (:class:`OnceEd25519`).
3. Height 2 with ``FISCO_QC=0``: per-signature votes, a signature-list
   header.
4. Height 3 with queued delivery (``auto=False``): the leader's proposal is
   prepared but every COMMIT is dropped; all four replicas time out, the
   view changes, and the new leader re-proposes the prepared block with its
   transactions. The three replicas check the full-tx proposal with
   ``batch_admit`` on the ``consensus`` lane; the port's three run together
   and a DevicePlane merges them (the frames they send are put back in the
   order a one-at-a-time delivery gives).
5. Forged packets: a PREPARE with a bad signature and a pre-prepare from a
   replica that does not lead are ignored.

Every frame on each gateway is held equal, in order, byte for byte, as are
the stable headers with their QC record or signature list, every row of
every replica's store (the ``ConsensusStorage`` rows among them), the pools,
the evidence, the chain-safety auditor's report (``audit_chain``) and step
1's pipeline stages. Then the JAX rows carried across by
``MemoryStorage.from_rows`` restore the same view and prepared proposal in
a port engine as in a JAX one.

Apart from the committee run: ``EvidenceGossip`` on four replicas of each
package carries a leader's equivocation, and a record that proves nothing,
to every peer (the same frames, verdicts, evidence and strikes), and an
armed crash plan fires at the engine's and sealer's seams, its flight
recorder flushed and merged by ``post_mortem``, as in JAX."""

from __future__ import annotations

import contextlib
import importlib
import json
import threading
import time
import types
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from chip_smoke import StandIn
from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.device.plane import DevicePlane
from fisco_bcos_tpu_torch.ops import _kernels
from test_torch_txpool import HostLegs  # the JAX suite on its host legs: no JAX program traced

SECRET = 0xF100D  # the committee's consensus secrets: SECRET + i
USER_SECRET = 0x5EED
FLOOD_TXS = 8  # the flood: blocks of BLOCK_TXS, the last one of 2
BLOCK_TXS = 3  # the genesis tx_count_limit
NOW_S = 1_700_000_123.456  # the sealers' clock: header timestamps
MODULES = (
    "consensus.engine", "consensus.sealer", "consensus.config", "consensus.qc", "consensus.messages",
    "consensus.storage", "consensus.block_validator", "consensus.audit", "front.front", "ledger.ledger",
    "storage.memory_storage", "storage.state_storage", "txpool.txpool", "txpool.quota", "protocol.block",
    "protocol.block_header", "protocol.transaction", "consensus.gossip", "resilience.crashpoints",
    "observability.flight",
)


class OnceEd25519(psuite.Ed25519Crypto):
    """The port's Ed25519Crypto on the CPU that checks each distinct lane
    (message, key, signature) once with the plain version: :meth:`prime`
    checks every new lane of a list in one plain batch, and
    ``batch_verify`` answers each lane from those verdicts, priming the
    lanes it has not seen (a plain batch costs ~3.5-5 s on the CPU whatever
    its lanes, and the four replicas of a round admit overlapping sets of
    the same votes). ``batches`` counts the plain batches."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.verdicts: dict = {}
        self.batches = 0

    def prime(self, lanes) -> None:
        new = sorted(set(lanes) - self.verdicts.keys())
        if new:
            self.batches += 1
            ok = np.asarray(super().batch_verify(*(list(col) for col in zip(*new))))
            self.verdicts.update(zip(new, ok.tolist()))

    def batch_verify(self, msg_hashes, pubs, sigs) -> np.ndarray:
        lanes = [tuple(bytes(x) for x in lane) for lane in zip(msg_hashes, pubs, sigs)]
        self.prime(lanes)
        return np.array([self.verdicts[lane] for lane in lanes], dtype=bool)


@contextlib.contextmanager
def jax_ed25519_lanes():
    """Every lane the JAX package's Ed25519 QC scheme checks in a batch
    while open, in a list."""
    impl = JAX.qc.get_scheme("ed25519")._impl
    lanes: list[tuple] = []
    real = impl.batch_verify

    def recording(msg_hashes, pubs, sigs):
        lanes.extend(tuple(bytes(x) for x in lane) for lane in zip(msg_hashes, pubs, sigs))
        return real(msg_hashes, pubs, sigs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(impl, "batch_verify", recording)
        yield lanes


def package(root: str) -> types.SimpleNamespace:
    """One package's modules under short names (``pkg.engine``, ``pkg.qc``...)."""
    return types.SimpleNamespace(
        root=root, **{name.split(".")[-1]: importlib.import_module(f"{root}.{name}") for name in MODULES}
    )


PORT = package("fisco_bcos_tpu_torch")
JAX = package("fisco_bcos_tpu")
PORT_SUITE = psuite.ecdsa_suite(device="cpu")
_jax_ecdsa = jsuite.ecdsa_suite()
JAX_SUITE = HostLegs(_jax_ecdsa.hash_impl, _jax_ecdsa.signature_impl)


def suite_of(pkg):
    return PORT_SUITE if pkg is PORT else JAX_SUITE


@contextlib.contextmanager
def schemes(ed_impl=None, bls_impl=None):
    """The port's process-wide QC schemes on the CPU (``qc._SCHEMES``, what
    ``get_scheme`` memoizes): Ed25519 on `ed_impl` (default
    :class:`OnceEd25519`), BLS on the port's ``BLSCrypto(cpu)``. Yields the
    Ed25519 implementation."""
    from fisco_bcos_tpu_torch.crypto import bls

    ed = PORT.qc.Ed25519QCScheme()
    ed._impl = ed_impl if ed_impl is not None else OnceEd25519()
    b = PORT.qc.BLSQCScheme()
    b._impl = bls_impl if bls_impl is not None else bls.BLSCrypto(torch.device("cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PORT.qc, "_SCHEMES", {"ed25519": ed, "bls": b})
        yield ed._impl


@contextlib.contextmanager
def clean_boards():
    """Both packages' strike boards and evidence logs empty, before and after."""
    for pkg in (PORT, JAX):
        pkg.quota.get_quotas().reset()
        pkg.audit.EVIDENCE.reset()
    try:
        yield
    finally:
        for pkg in (PORT, JAX):
            pkg.quota.get_quotas().reset()
            pkg.audit.EVIDENCE.reset()


def recording_gateway(pkg, auto: bool):
    """The package's InprocGateway, every frame it is handed kept in
    ``frames`` as (module, src, dst, payload), in order; a frame handed
    over on a thread that set ``tag.value`` is kept as (tag, frame) in
    ``tagged`` instead, for :func:`deliver_together` to order."""

    class Recording(pkg.front.InprocGateway):
        def __init__(self):
            super().__init__(auto=auto)
            self.frames: list[tuple] = []
            self.tag = threading.local()
            self.tagged: list[tuple] = []

        def _enqueue(self, module_id, src, dst, payload):
            tag = getattr(self.tag, "value", None)
            with self._lock:
                if tag is not None:  # queued by deliver_together, in order
                    self.tagged.append((tag, (module_id, src, dst, payload)))
                    return
                self.frames.append((module_id, src, dst, payload))
            super()._enqueue(module_id, src, dst, payload)

    return Recording()


@dataclass
class Replica:
    suite: object
    keypair: object
    store: object
    ledger: object
    pool: object
    front: object
    config: object
    scheduler: StandIn
    engine: object
    sealer: object
    cstore: object

    @property
    def node_id(self) -> bytes:
        return self.keypair.pub


def keys(pkg, n: int = 4):
    sig = suite_of(pkg).signature_impl
    return [sig.generate_keypair(secret=SECRET + i) for i in range(n)]


def members_of(pkg):
    """The committee: each member's key and its Ed25519 QC key, derived from
    its secret."""
    return [pkg.ledger.ConsensusNode(kp.pub, weight=1, qc_pub=pkg.qc.qc_pub_for(kp.secret, "ed25519"))
            for kp in keys(pkg)]


def build_replica(pkg, kp, store, gw) -> Replica:
    """One replica over `store` (its genesis written if the store has none),
    its front connected to `gw`."""
    suite = suite_of(pkg)
    ledger = pkg.ledger.Ledger(store, suite)
    ledger.build_genesis(pkg.ledger.GenesisConfig(
        consensus_nodes=members_of(pkg), tx_count_limit=BLOCK_TXS, timestamp=1_700_000_000_000))
    pool = pkg.txpool.TxPool(suite, ledger, quotas=pkg.quota.AdmissionQuotas())
    front = pkg.front.FrontService(kp.pub)
    gw.connect(front)
    cfg_l = ledger.ledger_config()
    config = pkg.config.PBFTConfig(suite=suite, keypair=kp, nodes=cfg_l.consensus_nodes,
                                   leader_period=cfg_l.leader_period, head=ledger.block_number())
    sched = StandIn(suite, store, ledger, pool,
                    (pkg.block_header.BlockHeader, pkg.block.Block, pkg.state_storage.StateStorage))
    cstore = pkg.storage.ConsensusStorage(store)
    engine = pkg.engine.PBFTEngine(config, sched, pool, ledger, front, consensus_storage=cstore)
    sealer = pkg.sealer.Sealer(config, pool, ledger, engine)
    return Replica(suite, kp, store, ledger, pool, front, config, sched, engine, sealer, cstore)


def build_committee(pkg, auto: bool = True):
    """Four replicas of one package over one recording gateway."""
    gw = recording_gateway(pkg, auto)
    return gw, [build_replica(pkg, kp, pkg.memory_storage.MemoryStorage(), gw) for kp in keys(pkg)]


def leader(replicas, number: int, view: int = 0):
    idx = replicas[0].config.leader_index(number, view)
    nid = replicas[0].config.nodes[idx].node_id
    return next(r for r in replicas if r.keypair.pub == nid)


def flood_wires() -> list[bytes]:
    """FLOOD_TXS transfer transactions from one user, signed on the port's
    host legs, as wire bytes."""
    tx_mod = PORT.transaction
    kp = PORT_SUITE.signature_impl.generate_keypair(secret=USER_SECRET)
    out = []
    for i in range(FLOOD_TXS):
        t = tx_mod.Transaction(version=1, chain_id="chain0", group_id="group0", block_limit=500, nonce=f"c{i:04d}",
                               to=bytes([0x10]) * 20, input=bytes.fromhex("a9059cbb") + i.to_bytes(64, "big"),
                               import_time=1_700_000_000_000 + i)
        t.signature = PORT_SUITE.signature_impl.sign(kp, t.hash(PORT_SUITE))
        out.append(t.encode())
    return out


def concurrently(calls) -> list:
    """Each call on a thread of its own, all started together; their
    results in order (an exception is re-raised here)."""
    out = [None] * len(calls)

    def run(i, fn):
        try:
            out[i] = ("ok", fn())
        except BaseException as e:  # noqa: BLE001 — handed back to the test's thread
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


@contextlib.contextmanager
def merging_plane(items: int, pkg=None):
    """A fresh process plane of `pkg` (the port's by default) whose window
    holds until `items` lanes are queued, so concurrent callers merge into
    one dispatch."""
    mod = plane_mod if pkg in (None, PORT) else importlib.import_module("fisco_bcos_tpu.device.plane")
    plane = mod.DevicePlane(window_ms=60_000, high_water=items, starvation_ms=60_000)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_PLANE", plane)
        yield plane


@contextlib.contextmanager
def fresh_pipeline(pkg):
    """A fresh pipeline recorder of `pkg` in place of its ``PIPELINE``
    (the port's pool and plane bound it at import; the JAX modules import
    it at each call), so its snapshot holds one step's stages."""
    mod = importlib.import_module(f"{pkg.root}.observability.pipeline")
    rec = mod.PipelineRecorder(enabled=True, emit_metrics=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "PIPELINE", rec)
        if pkg is PORT:
            mp.setattr(plane_mod, "PIPELINE", rec)
            mp.setattr(PORT.txpool, "PIPELINE", rec)
        yield rec


def submit_everywhere(pkg, replicas, wires) -> tuple[list, dict]:
    """Every replica's pool takes the wires, decoded in its own package, the
    four ``submit_batch`` calls together through one merged admission
    dispatch. Returns each lane's result and the pipeline stages the step
    gave (no time: the states, intervals and blocked-on edges)."""
    batches = [[pkg.transaction.Transaction.decode(w) for w in wires] for _ in replicas]
    with fresh_pipeline(pkg) as rec, merging_plane(len(wires) * len(replicas), pkg) as plane:
        results = concurrently([lambda r=r, b=b: r.pool.submit_batch(b) for r, b in zip(replicas, batches)])
        assert plane.stats()["dispatches"] == 1
        stages = {name: {k: sorted(v) if k == "blocked_ms" else v for k, v in st.items()
                         if k not in ("busy_ms", "utilization", "utilization_lifetime")}
                  for name, st in rec.snapshot().items()}
    return [[(x.tx_hash, int(x.status), x.sender) for x in res] for res in results], stages


def deliver_together(gw, frames, items: int) -> None:
    """Deliver queued `frames` (each to its own replica) on one thread each,
    all together, through a plane that merges their `items` lanes into one
    dispatch; the frames they send go back into the queue in the order a
    one-at-a-time delivery of `frames` gives."""
    def run(i, frame):
        module_id, src, dst, payload = frame
        gw.tag.value = i
        try:
            gw._fronts[dst].on_receive(module_id, src, payload)
        finally:
            gw.tag.value = None

    with merging_plane(items):
        concurrently([lambda i=i, f=f: run(i, f) for i, f in enumerate(frames)])
    sent = [f for _, f in sorted(gw.tagged, key=lambda tf: tf[0])]  # stable: each thread's own order kept
    gw.tagged.clear()
    gw.frames.extend(sent)
    gw._queue.extend(sent)


def drain(gw, drop=lambda msg: False, together=lambda msg: False, items: int = 0) -> None:
    """Deliver the queue round by round, as ``InprocGateway.deliver_all``
    does: a frame whose decoded message `drop` names is discarded, and a run
    of frames that `together` names goes through :func:`deliver_together`,
    `items` lanes a frame (in the port's committee only: the JAX one takes them in turn, which is
    the same order)."""
    decode = gw.decode
    for _ in range(100):
        with gw._lock:
            batch, gw._queue = gw._queue, []
        if not batch:
            return
        i = 0
        while i < len(batch):
            if drop(decode(batch[i][3])):
                i += 1
                continue
            j = i
            while j < len(batch) and together(decode(batch[j][3])) and not drop(decode(batch[j][3])):
                j += 1
            if j - i > 1 and gw.port:
                deliver_together(gw, batch[i:j], items * (j - i))
                i = j
                continue
            module_id, src, dst, payload = batch[i]
            front = gw._fronts.get(dst)
            if front is not None:
                front.on_receive(module_id, src, payload)
            i += 1
    raise AssertionError("the queue did not drain")


def rows(store) -> list[tuple]:
    return sorted((t, bytes(k), dict(e.fields), int(e.status)) for t, k, e in store.traverse())


def run_scenario(pkg, wires, monkeypatch) -> dict:
    """Steps 1-5 in one package; what each gave, as plain values."""
    out: dict = {}
    monkeypatch.setattr(pkg.sealer, "time", types.SimpleNamespace(time=lambda: NOW_S, perf_counter=time.perf_counter))
    gw, reps = build_committee(pkg)
    gw.port = pkg is PORT
    gw.decode = pkg.messages.PBFTMessage.decode
    PacketType = pkg.messages.PacketType
    out["keys"] = [(r.keypair.pub, r.config.qc_keypair.pub) for r in reps]
    out["submitted"], out["pipeline"] = submit_everywhere(pkg, reps, wires)

    # height 1: the Ed25519 QC
    monkeypatch.delenv("FISCO_QC", raising=False)
    monkeypatch.setenv("FISCO_QC_SCHEME", "ed25519")
    assert leader(reps, 1).sealer.seal_and_submit()
    assert [r.ledger.block_number() for r in reps] == [1] * 4
    # height 2: per-signature votes
    monkeypatch.setenv("FISCO_QC", "0")
    assert leader(reps, 2).sealer.seal_and_submit()
    assert [r.ledger.block_number() for r in reps] == [2] * 4
    # height 3: prepared, commits dropped, a view change, the re-proposal
    gw.auto = False
    first = leader(reps, 3)
    assert first.sealer.seal_and_submit()
    drain(gw, drop=lambda m: m.packet_type == PacketType.COMMIT)
    out["prepared"] = [bool((c := r.engine._caches.get(3)) is not None and c.prepared) for r in reps]
    out["prepared_rows"] = [rows(r.store) for r in reps]
    assert [r.ledger.block_number() for r in reps] == [2] * 4
    for r in reps:
        r.engine.on_timeout()
    drain(gw, together=lambda m: m.packet_type == PacketType.PRE_PREPARE, items=FLOOD_TXS - 2 * BLOCK_TXS)
    out["views"] = [r.engine.view for r in reps]
    assert [r.ledger.block_number() for r in reps] == [3] * 4
    out["reproposer"] = reps.index(leader(reps, 3, view=1))

    # forged packets: a bad-signature PREPARE, a pre-prepare from a non-leader
    gw.auto = True
    victim = reps[0]
    forged = pkg.messages.PBFTMessage(packet_type=PacketType.PREPARE, view=victim.engine.view, number=4,
                                      proposal_hash=b"\x01" * 32)
    forged.generated_from = 1
    forged.signature = b"\x00" * 65
    before = dict(victim.engine._caches)
    victim.engine.handle_message(forged)
    out["forged_prepare_ignored"] = victim.engine._caches == before
    block = pkg.block.Block(header=pkg.block_header.BlockHeader(number=4))
    pp = pkg.messages.PBFTMessage(packet_type=PacketType.PRE_PREPARE, view=victim.engine.view, number=4,
                                  proposal_hash=block.header.hash(suite_of(pkg)), proposal_data=block.encode())
    outsider = next(i for i in range(4) if i != victim.config.leader_index(4, victim.engine.view))
    pp.generated_from = outsider
    pp.sign(suite_of(pkg), next(r.keypair for r in reps if r.keypair.pub == victim.config.nodes[outsider].node_id))
    victim.engine.handle_message(pp)
    out["non_leader_ignored"] = (c := victim.engine._caches.get(4)) is None or c.pre_prepare is None

    out["frames"] = list(gw.frames)
    out["headers"] = [[r.ledger.header_by_number(n).encode() for n in range(4)] for r in reps]
    out["rows"] = [rows(r.store) for r in reps]
    out["consensus_rows"] = [[x for x in rows(r.store) if x[0] == pkg.storage.TABLE] for r in reps]
    out["pools"] = [(r.pool.pending_count(), r.pool.unsealed_count()) for r in reps]
    out["evidence"] = pkg.audit.EVIDENCE.snapshot()
    out["heads"] = [r.engine.consensus_head() for r in reps]
    # the certificates are held by the validator tests (a plain signature-list batch costs seconds)
    out["audit"] = pkg.audit.audit_chain(reps, check_certs=False)
    out["replicas"] = reps
    return out


@pytest.fixture(scope="module")
def scenario():
    wires = flood_wires()
    with clean_boards(), schemes() as ed, pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        with jax_ed25519_lanes() as lanes:
            jax = run_scenario(JAX, wires, mp)
        ed.prime(lanes)  # one plain batch: the votes are the same in both committees
        port = run_scenario(PORT, wires, mp)
        port["ed25519_batches"] = ed.batches
    return jax, port


def test_every_frame_and_row_equals_the_jax_committee(scenario):
    jax, port = scenario
    assert port["keys"] == jax["keys"]
    assert port["submitted"] == jax["submitted"]
    assert port["pipeline"] == jax["pipeline"]
    assert all(st == 0 for res in port["submitted"] for _, st, _ in res)
    assert port["prepared"] == jax["prepared"] and any(port["prepared"])
    assert port["views"] == jax["views"] == [1] * 4
    assert port["reproposer"] == jax["reproposer"]
    assert len(port["frames"]) == len(jax["frames"])
    for i, (p, j) in enumerate(zip(port["frames"], jax["frames"])):
        assert p == j, f"frame {i} differs"
    assert port["headers"] == jax["headers"]
    assert port["consensus_rows"] == jax["consensus_rows"]
    assert port["rows"] == jax["rows"]
    assert port["pools"] == jax["pools"] == [(0, 0)] * 4
    assert port["evidence"] == jax["evidence"]
    assert port["heads"] == jax["heads"]
    assert port["audit"] == jax["audit"] and port["audit"]["ok"] and port["audit"]["common_height"] == 3
    assert port["forged_prepare_ignored"] and jax["forged_prepare_ignored"]
    assert port["non_leader_ignored"] and jax["non_leader_ignored"]


def test_the_heights_carry_what_each_mode_stamps(scenario):
    """Height 1 carries an Ed25519 QC record of a quorum, height 2 a
    signature list, height 3 (re-proposed in view 1) the prepared block's
    transactions; every replica holds the same chain, and the port's
    BlockValidator accepts each header as the JAX one does."""
    jax, port = scenario
    reps = port["replicas"]
    h1, h2, h3 = (PORT.block_header.BlockHeader.decode(port["headers"][0][n]) for n in (1, 2, 3))
    cert = PORT.qc.QuorumCert.decode(h1.qc)
    assert cert.scheme == "ed25519" and cert.committee == 4 and len(cert.signers()) >= 3 and not h1.signature_list
    assert not h2.qc and len(h2.signature_list) >= 3
    assert not h3.qc and len(h3.signature_list) >= 3
    for n in (1, 2, 3):  # one block everywhere; each replica stamps the quorum it admitted
        assert len({PORT.block_header.BlockHeader.decode(h[n]).hash(PORT_SUITE) for h in port["headers"]}) == 1
    for n in (1, 2, 3):
        block = reps[0].ledger.block_by_number(n)
        assert len(block.transactions) == min(BLOCK_TXS, FLOOD_TXS - (n - 1) * BLOCK_TXS)
        assert block.header.txs_root == block.calculate_txs_root(PORT_SUITE)
    # one plain batch: every vote the port's committee checked, the JAX one checked too
    assert port["ed25519_batches"] == 1, port["ed25519_batches"]


def restored(pkg, store_rows, kp):
    """A replica of `pkg` over a MemoryStorage holding `store_rows` (the
    port's ``from_rows``; the JAX store's entries set the same way), its
    view change recorded on a gateway of its own."""
    if pkg is PORT:
        store = pkg.memory_storage.MemoryStorage.from_rows(store_rows)
    else:
        from fisco_bcos_tpu.storage.entry import Entry, EntryStatus

        store = pkg.memory_storage.MemoryStorage()
        for table, key, fields, status in store_rows:
            store._data[(table, key)] = Entry(dict(fields), EntryStatus(status))
    gw = recording_gateway(pkg, auto=True)
    for peer in keys(pkg):  # fronts with no engine: the frames stop there
        if peer.pub != kp.pub:
            gw.connect(pkg.front.FrontService(peer.pub))
    return gw, build_replica(pkg, kp, store, gw)


def test_jax_rows_restore_the_view_and_the_prepared_proposal(scenario, monkeypatch):
    """The JAX committee's stores, carried across as plain rows
    (``MemoryStorage.from_rows``), restore in a port engine what they
    restore in a JAX engine: at the prepared point of height 3, the head
    and the prepared proposal with its proof, which the restarted engine
    re-offers in a view change byte for byte as the JAX one does; after the
    run, the head and view 1."""
    jax, port = scenario
    monkeypatch.setenv("FISCO_QC", "0")
    for i, kp in enumerate(keys(PORT)):
        jkp = keys(JAX)[i]
        for when in ("prepared_rows", "rows"):
            pgw, p = restored(PORT, jax[when][i], kp)
            jgw, j = restored(JAX, jax[when][i], jkp)
            assert rows(p.store) == rows(j.store) == jax[when][i]
            assert (p.engine.view, p.engine.committed_number) == (j.engine.view, j.engine.committed_number)
            assert p.engine._recovered_prepared == j.engine._recovered_prepared
            if when == "prepared_rows":
                assert p.engine.committed_number == 2 and (p.engine._recovered_prepared is not None) == jax["prepared"][i]
                p.engine.on_timeout()
                j.engine.on_timeout()
                assert pgw.frames == jgw.frames and len(pgw.frames) == 3  # the view change to three peers
            else:
                assert (p.engine.view, p.engine.committed_number) == (1, 3)


def test_the_pool_and_plane_pipeline_stages_equal_the_jax_ones(scenario):
    """Step 1's stages: four admission intervals, each blocked once on the
    device plane, and one device_plane dispatch, in both packages."""
    jax, port = scenario
    stages = port["pipeline"]
    assert stages == jax["pipeline"]
    assert set(stages) == {"admission", "device_plane"}
    assert stages["admission"]["intervals"] == 4 and stages["admission"]["blocked_intervals"] == 4
    assert stages["admission"]["blocked_ms"] == ["device_plane"]
    assert stages["device_plane"]["intervals"] == 1
    assert stages["admission"]["state"] == stages["device_plane"]["state"] == "idle"


# ---------------------------------------------------------------------------
# Evidence gossip, crash points and the flight recorder
# ---------------------------------------------------------------------------


def gossip_run(pkg) -> dict:
    """Four replicas of `pkg`, an ``EvidenceGossip`` on each front (inline
    delivery). A non-leader offers the leader's equivocation at height 5
    (two pre-prepares it signed); another broadcasts a record that proves
    nothing: height 6's leader named for pre-prepares the fabricator signed
    itself. Returns the gossip frames in order, each endpoint's snapshot,
    the evidence and the strikes."""
    suite = suite_of(pkg)
    PT = pkg.messages.PacketType
    gw, reps = build_committee(pkg)
    gossips = [pkg.gossip.EvidenceGossip(r.engine, r.front, r.keypair) for r in reps]
    cfg = reps[0].config

    def pre_prepare(number, timestamp, idx, kp):
        block = pkg.block.Block(header=pkg.block_header.BlockHeader(number=number, timestamp=timestamp))
        m = pkg.messages.PBFTMessage(packet_type=PT.PRE_PREPARE, view=0, number=number,
                                     proposal_hash=block.header.hash(suite), proposal_data=block.encode())
        m.generated_from = idx
        m.sign(suite, kp)
        return m

    lead = leader(reps, 5)
    lead_idx = cfg.leader_index(5, 0)
    witness = next(i for i, r in enumerate(reps) if r is not lead)
    gossips[witness].offer("equivocation", number=5, view=0, offender=lead_idx,
                           frames=[pre_prepare(5, t, lead_idx, lead.keypair) for t in (1, 2)], detail="seen here")
    victim_idx = cfg.leader_index(6, 0)
    victim = leader(reps, 6)
    fab = next(r for r in reps if r is not victim and r is not lead)
    body = {"kind": "equivocation", "number": 6, "view": 0, "offender": bytes(victim.keypair.pub).hex(),
            "reporter": bytes(fab.keypair.pub).hex(),
            "frames": [pre_prepare(6, t, victim_idx, fab.keypair).encode().hex() for t in (1, 2)],
            "detail": "fabricated"}
    blob = json.dumps(body, sort_keys=True).encode()
    sig = suite.signature_impl.sign(fab.keypair, suite.hash(blob))
    fab.front.broadcast(pkg.front.ModuleID.EVIDENCE_GOSSIP,
                        json.dumps({"body": blob.hex(), "sig": sig.hex(), "ttl": 3}).encode())
    return {"frames": list(gw.frames), "snapshots": [g.snapshot() for g in gossips],
            "evidence": pkg.audit.EVIDENCE.snapshot(), "strikes": strikes_of(pkg),
            "leader": bytes(lead.keypair.pub).hex(), "victim": bytes(victim.keypair.pub).hex()}


def strikes_of(pkg) -> dict:
    q = pkg.quota.get_quotas()
    return {g: {s: len(d) for s, d in st.strikes.items()} for g, st in q._groups.items()}


def test_evidence_gossip_equals_the_jax_gossip():
    got = {}
    for pkg in (JAX, PORT):
        with clean_boards(), schemes():
            got[pkg.root] = gossip_run(pkg)
    port, jax = got["fisco_bcos_tpu_torch"], got["fisco_bcos_tpu"]
    assert len(port["frames"]) == len(jax["frames"])
    for i, (p, j) in enumerate(zip(port["frames"], jax["frames"])):
        assert p == j, f"frame {i} differs"
    assert port == jax
    # the equivocation converged everywhere; the fabricated record struck nobody
    assert all(s["offenders"] == [port["leader"]] for s in port["snapshots"])
    assert sum(s["confirmed"] for s in port["snapshots"]) == 3 and sum(s["published"] for s in port["snapshots"]) == 1
    assert sum(s["rejected"] for s in port["snapshots"]) >= 1
    assert {r["kind"] for r in port["evidence"]} == {"equivocation"}
    assert all(port["victim"] not in s["offenders"] for s in port["snapshots"])


def crash_run(pkg, directory, monkeypatch) -> tuple:
    """`pkg`'s crash plan armed from ``FISCO_CRASH_PLAN`` (the engine's
    pre-commit seam on scope ab12 after one pass, and the sealer's seam on
    any scope), the seams hit in a fixed order, a flight recorder on a
    counting clock flushed into `directory` at each firing, then
    ``post_mortem`` over it. Returns what each hit did, the plan's firings,
    the ring, the files and the post-mortem."""
    cp, fl = pkg.crashpoints, pkg.flight
    ticks = iter(range(1_000))
    rec = fl.FlightRecorder(enabled=True, clock=lambda: float(next(ticks)), wallclock=lambda: 1_700_000_000.0)
    monkeypatch.setattr(fl, "FLIGHT", rec)
    monkeypatch.setenv("FISCO_FLIGHT_DIR", str(directory))
    monkeypatch.setenv("FISCO_CRASH_PLAN", "engine.pre_commit_broadcast@ab12,after=1;sealer.mid_prebuild")
    monkeypatch.setattr(cp, "_env_checked", False)
    monkeypatch.setattr(cp, "_PLAN", None)
    cp.ensure_env_crash_plan()
    plan = cp.active_crash_plan()
    hits = []
    try:
        for name, scope in (("engine.pre_commit_broadcast", "zz99"), ("engine.pre_commit_broadcast", "ab12cd"),
                            ("engine.pre_commit_broadcast", "ab12cd"), ("engine.pre_commit_broadcast", "ab12cd"),
                            ("sealer.mid_prebuild", "n1"), ("engine.post_head_advance", "ab12cd")):
            try:
                cp.crashpoint(name, scope)
                hits.append("passed")
            except cp.InjectedCrash as e:
                hits.append(str(e))
    finally:
        cp.clear_crash_plan()
    files = {f.name: json.loads(f.read_text()) for f in sorted(directory.iterdir())}
    return hits, plan.fired, rec.snapshot(), files, fl.post_mortem(str(directory))


def test_crash_plan_and_flight_recorder_equal_the_jax_ones(tmp_path, monkeypatch):
    got = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.root
        d.mkdir()
        got[pkg.root] = crash_run(pkg, d, monkeypatch)
    port, jax = got["fisco_bcos_tpu_torch"], got["fisco_bcos_tpu"]
    assert port == jax
    hits, fired, ring, files, pm = port
    assert hits[0] == hits[1] == hits[3] == hits[5] == "passed"
    assert "engine.pre_commit_broadcast" in hits[2] and "sealer.mid_prebuild" in hits[4]
    assert fired == [("engine.pre_commit_broadcast", "ab12cd"), ("sealer.mid_prebuild", "n1")]
    assert sorted(files) == ["flight_ab12cd.json", "flight_n1.json"]
    assert [e["name"] for e in ring] == ["armed", "armed", "fired", "fired"]
    assert set(pm["nodes"]) == {"ab12cd", "n1"} and len(pm["timeline"]) == 3 + 4
