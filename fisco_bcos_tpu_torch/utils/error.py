"""Error type and protocol error codes (the port's copy of the JAX
package's ``utils/error.py``, the same values).

Reference: bcos-utilities/Error.h and bcos-framework CommonError.h. The
transaction status family lives in :class:`..protocol.receipt.TransactionStatus`;
the txpool admission values here match TransactionStatus.h:54-63, since the
reference reports them through the same numeric space.
"""

from __future__ import annotations

from enum import IntEnum


class ErrorCode(IntEnum):
    SUCCESS = 0
    # TxPool admission (reference: bcos-protocol TransactionStatus.h:54-63)
    NONCE_CHECK_FAIL = 10000
    BLOCK_LIMIT_CHECK_FAIL = 10001
    TX_POOL_FULL = 10002
    MALFORM = 10003
    ALREADY_IN_TX_POOL = 10004
    TX_ALREADY_IN_CHAIN = 10005
    INVALID_CHAIN_ID = 10006
    INVALID_GROUP_ID = 10007
    INVALID_SIGNATURE = 10008
    REQUEST_NOT_BELONG_TO_THE_GROUP = 10009
    # multi-tenant isolation: the group's admission quota is exceeded, or
    # the submitting source is demoted after repeated invalid signatures
    OVER_GROUP_QUOTA = 10010
    SOURCE_DEMOTED = 10011
    # Scheduler / executor
    SCHEDULER_INVALID_BLOCK = 21000
    SCHEDULER_BLOCK_IN_QUEUE = 21001
    EXECUTOR_ERROR = 22000
    DEAD_LOCK = 22001
    # Consensus
    CONSENSUS_INVALID_PROPOSAL = 23000
    CONSENSUS_INVALID_VIEW = 23001
    CONSENSUS_TIMEOUT = 23002
    # Storage
    STORAGE_ERROR = 24000
    TABLE_NOT_EXIST = 24001
    TABLE_ALREADY_EXIST = 24002


class BcosError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(f"[{code}] {message}")
        self.code = int(code)
        self.message = message
