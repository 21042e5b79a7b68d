"""Front service — module-ID demux between node modules and the gateway.

Reference: bcos-front/FrontService.h (registerModuleMessageDispatcher:189,
asyncSendMessageByNodeID:72, asyncSendBroadcastMessage:102) and the ModuleID
enum (bcos-framework/protocol/Protocol.h:67-87). The in-process gateway is
the test-fixture transport the reference builds as FakeFrontService
(bcos-framework/testutils/faker/FakeFrontService.h) — N nodes in one process,
messages delivered by direct call; the TCP gateway rides the same interface.
"""

from __future__ import annotations

import threading
from enum import IntEnum
from typing import Callable

from ..utils.log import get_logger

_log = get_logger("front")


class ModuleID(IntEnum):
    """bcos-framework/protocol/Protocol.h:67-87."""

    PBFT = 1000
    RAFT = 1001
    BLOCK_SYNC = 2000
    TXS_SYNC = 2001
    CONS_TXS_SYNC = 2002
    AMOP = 3000
    LIGHTNODE_GET_BLOCK = 4000
    LIGHTNODE_GET_TRANSACTIONS = 4001
    LIGHTNODE_GET_RECEIPTS = 4002
    LIGHTNODE_GET_STATUS = 4003
    LIGHTNODE_SEND_TRANSACTION = 4004
    LIGHTNODE_CALL = 4005
    # batched proof fetch (the read path): one round trip carries N
    # tx/receipt proofs, served from the full node's ProofPlane cache
    LIGHTNODE_GET_PROOFS = 4006
    # federated telemetry pull: any node asks a peer for its
    # metrics snapshot / round ledger / clock probe over the same mesh
    FLEET_TELEMETRY = 4007
    # byzantine-evidence gossip: signed, self-attributing
    # evidence records re-broadcast so demotion converges committee-wide
    EVIDENCE_GOSSIP = 4008
    # batched state-membership proofs (the succinct plane): N
    # (table, key) proofs against one height's header state commitment
    LIGHTNODE_GET_STATE_PROOFS = 4009
    SYNC_PUSH_TRANSACTION = 5000

# callback(from_node_id: bytes, payload: bytes) -> None
Dispatcher = Callable[[bytes, bytes], None]


class FrontService:
    """One node's message mux. `node_id` is the node's public key."""

    def __init__(self, node_id: bytes):
        self.node_id = node_id
        self._dispatch: dict[int, Dispatcher] = {}
        self._gateway: "GatewayInterface | None" = None
        self._lock = threading.RLock()

    def register_module(self, module_id: int, cb: Dispatcher) -> None:
        with self._lock:
            self._dispatch[int(module_id)] = cb

    def set_gateway(self, gw: "GatewayInterface") -> None:
        self._gateway = gw

    # outbound (no gateway = solo node: messages drop, consensus of one
    # proceeds locally — same as the reference's single-node Air chain)
    def send_message(self, module_id: int, dst: bytes, payload: bytes) -> None:
        if self._gateway is None:
            _log.debug("no gateway: dropping send to %s", dst.hex()[:8])
            return
        self._gateway.send(int(module_id), self.node_id, dst, payload)

    def broadcast(self, module_id: int, payload: bytes) -> None:
        if self._gateway is None:
            _log.debug("no gateway: dropping broadcast")
            return
        self._gateway.broadcast(int(module_id), self.node_id, payload)

    # inbound (called by the gateway)
    def on_receive(self, module_id: int, src: bytes, payload: bytes) -> None:
        with self._lock:
            cb = self._dispatch.get(int(module_id))
        if cb is None:
            _log.warning("no dispatcher for module %s", module_id)
            return
        cb(src, payload)


class GatewayInterface:
    """``group`` (keyword-only, default "") attributes the frame to a chain
    group for multi-tenant bandwidth accounting — transports that police
    budgets label their drop counters with it; others ignore it."""

    def send(
        self, module_id: int, src: bytes, dst: bytes, payload: bytes,
        group: str = "",
    ) -> None:
        raise NotImplementedError

    def broadcast(
        self, module_id: int, src: bytes, payload: bytes, group: str = ""
    ) -> None:
        raise NotImplementedError


class InprocGateway(GatewayInterface):
    """Direct-call transport connecting N fronts in one process.

    Messages are queued and drained explicitly (`deliver_all`) or delivered
    inline (`auto=True`); explicit draining lets consensus tests order and
    drop messages deterministically (the PBFTFixture pattern)."""

    def __init__(self, auto: bool = True):
        self._fronts: dict[bytes, FrontService] = {}
        self._queue: list[tuple[int, bytes, bytes, bytes]] = []
        self.auto = auto
        self.dropped: Callable[[int, bytes, bytes], bool] | None = None
        self._lock = threading.RLock()

    def connect(self, front: FrontService) -> None:
        with self._lock:
            self._fronts[front.node_id] = front
        front.set_gateway(self)

    def disconnect(self, node_id: bytes) -> None:
        with self._lock:
            self._fronts.pop(node_id, None)

    def _enqueue(self, module_id: int, src: bytes, dst: bytes, payload: bytes) -> None:
        if self.dropped is not None and self.dropped(module_id, src, dst):
            return
        if self.auto:
            with self._lock:
                front = self._fronts.get(dst)
            if front is not None:
                front.on_receive(module_id, src, payload)
        else:
            with self._lock:
                self._queue.append((module_id, src, dst, payload))

    def send(
        self, module_id: int, src: bytes, dst: bytes, payload: bytes,
        group: str = "",
    ) -> None:
        self._enqueue(module_id, src, dst, payload)

    def broadcast(
        self, module_id: int, src: bytes, payload: bytes, group: str = ""
    ) -> None:
        with self._lock:
            targets = [nid for nid in self._fronts if nid != src]
        for dst in targets:
            self._enqueue(module_id, src, dst, payload)

    def deliver_all(self, max_rounds: int = 100) -> int:
        """Drain queued messages (including ones generated while draining)."""
        delivered = 0
        for _ in range(max_rounds):
            with self._lock:
                batch, self._queue = self._queue, []
            if not batch:
                break
            for module_id, src, dst, payload in batch:
                with self._lock:
                    front = self._fronts.get(dst)
                if front is not None:
                    front.on_receive(module_id, src, payload)
                    delivered += 1
        return delivered
