"""PBFT consensus: engine, sealer, block validator, safety auditor."""

from .engine import PBFTEngine  # noqa: F401
from .config import PBFTConfig  # noqa: F401
from .sealer import Sealer  # noqa: F401
from .block_validator import BlockValidator  # noqa: F401
from .audit import (  # noqa: F401
    EVIDENCE,
    assert_chain_safe,
    audit_chain,
    record_evidence,
)
