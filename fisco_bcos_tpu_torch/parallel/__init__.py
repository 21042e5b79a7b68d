"""Multi-device fan-out of the verification plane (mesh, shards, gathers)."""

from .sharding import (  # noqa: F401
    make_mesh,
    sharded_admission,
    sharded_ed25519_verify,
    sharded_merkle_root,
    sharded_qc_check,
    sharded_sm2_verify,
    sharded_state_root,
    sharded_verify,
)
