"""Protocol objects: Transaction, Receipt, BlockHeader, Block (the port's
copies of the JAX package's ``protocol`` modules: the same encodings and
hashes, each batch hash and merkle root on the port's suite).

The data-object layer the reference defines once as Tars structs and wraps
with framework interfaces (bcos-framework/protocol/*.h +
bcos-tars-protocol/protocol/*Impl.*). Canonical bytes come from codec.flat.
"""

from .transaction import Transaction, TransactionAttribute, TransactionFactory  # noqa: F401
from .receipt import LogEntry, TransactionReceipt, TransactionStatus  # noqa: F401
from .block_header import BlockHeader, ParentInfo, SignatureTuple  # noqa: F401
from .block import Block  # noqa: F401
