"""Ledger: chain data schema, genesis, block access, merkle proofs (the
port's copy of the JAX package's ``ledger``)."""

from .ledger import GenesisConfig, Ledger, LedgerConfig, ConsensusNode  # noqa: F401
