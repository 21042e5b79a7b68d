"""The signature programs' precomputed state, in the port's layout.

secp256k1 (recover and verify): the affine comb table of G and 2^128·G and
the GLV split constants, and the verify kernel's wider comb (c = 1..16).
SM2 (verify): the Montgomery-domain affine comb of G and the Montgomery
constants of its field (−p⁻¹, R mod p, R² mod p). Ed25519 (verify): the
kernel's comb of B, the first 8 entries of the JAX package's 15-entry
``b_comb_table`` (:func:`ed25519_comb_words`). The
port builds both itself from its reference copy (:func:`build_tables`,
:func:`build_sm2_tables`); :func:`tables_from_jax` and
:func:`sm2_tables_from_jax` carry the JAX package's numpy arrays of the same
state into the same layout, so a test can pin the two equal. The CUDA
kernels read the combs as 32-bit words ([60, 8], [30, 8]); the plain
versions read 16-bit limbs ([60, 16], [30, 16]); both come from one table
here.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .crypto.ref.ecdsa import SECP256K1, SM2_CURVE, point_add, point_mul
from .ops import ec, limb


def limbs16_to_words(table: np.ndarray) -> np.ndarray:
    """[..., 16] 16-bit limbs -> [..., 8] uint32 little-endian words."""
    t = np.asarray(table, dtype=np.uint64)
    return (t[..., 0::2] | (t[..., 1::2] << 16)).astype(np.uint32)


def words_to_limbs16(words: np.ndarray) -> np.ndarray:
    """[..., 8] uint32 words -> [..., 16] uint32 16-bit limbs."""
    w = np.asarray(words, dtype=np.uint32)
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(*w.shape[:-1], 16)


def _limbs_int(limbs) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(np.asarray(limbs).tolist()))


@dataclass(frozen=True)
class RecoverTables:
    """comb_words: [60, 8] uint32 — x of c·G (rows 0..14), y of c·G (15..29),
    then the same for 2^128·G (30..59), c = 1..15, affine, canonical.
    glv: the GLV split constants."""

    comb_words: np.ndarray
    glv: ec.GlvParams

    def comb_limbs(self) -> np.ndarray:
        return words_to_limbs16(self.comb_words)

    def same_as(self, other: "RecoverTables") -> bool:
        return np.array_equal(self.comb_words, other.comb_words) and self.glv == other.glv


def build_tables() -> RecoverTables:
    """The port's own tables, built from its reference copy."""
    return RecoverTables(
        comb_words=limbs16_to_words(ec.g_comb_table_glv()), glv=ec.glv_params()
    )


@lru_cache(maxsize=None)
def default_tables() -> RecoverTables:
    return build_tables()


@lru_cache(maxsize=None)
def verify_comb_words() -> np.ndarray:
    """The verify kernel's [64, 8] uint32 comb for its 5-bit signed windows:
    x of c·G (rows 0..15), y of c·G (16..31), then the same for 2^128·G
    (32..63), c = 1..16, affine, canonical; built from Python integers."""
    c = SECP256K1
    rows = []
    for base in ((c.gx, c.gy), point_mul(c, 1 << 128, (c.gx, c.gy))):
        pts, acc = [], None
        for _ in range(16):
            acc = point_add(c, acc, base)
            pts.append(acc)
        rows += [x for x, _ in pts] + [y for _, y in pts]
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in rows], dtype=np.uint32)


def tables_from_jax(g_comb_table_glv: np.ndarray, glv_params) -> RecoverTables:
    """Convert the JAX package's state to the port's layout.

    g_comb_table_glv: [60, 16] uint32 16-bit limbs, as
    ``fisco_bcos_tpu.ops.ec.g_comb_table_glv("secp256k1")`` returns it.
    glv_params: an object with the JAX ``_GlvParams`` fields as limb arrays
    (beta_enc, g1, g2, a1, b1_abs, a2, b2), as
    ``fisco_bcos_tpu.ops.ec.glv_params("secp256k1")`` returns it.
    """
    table = np.asarray(g_comb_table_glv)
    if table.shape != (60, 16):
        raise ValueError(f"comb table must be [60, 16], got {table.shape}")
    return RecoverTables(
        comb_words=limbs16_to_words(table),
        glv=ec.GlvParams(
            beta=_limbs_int(glv_params.beta_enc),
            g1=_limbs_int(glv_params.g1),
            g2=_limbs_int(glv_params.g2),
            a1=_limbs_int(glv_params.a1),
            b1_abs=_limbs_int(glv_params.b1_abs),
            a2=_limbs_int(glv_params.a2),
            b2=_limbs_int(glv_params.b2),
        ),
    )


@dataclass(frozen=True)
class Sm2Tables:
    """comb_words: [30, 8] uint32 — Montgomery-domain x of c·G (rows 0..14)
    and y (15..29), c = 1..15, affine, canonical. mprime, r1, r2: −p⁻¹ mod
    2^256, R mod p and R² mod p of SM2's p (R = 2^256)."""

    comb_words: np.ndarray
    mprime: int
    r1: int
    r2: int

    def comb_limbs(self) -> np.ndarray:
        return words_to_limbs16(self.comb_words)

    def same_as(self, other: "Sm2Tables") -> bool:
        return np.array_equal(self.comb_words, other.comb_words) and (
            self.mprime, self.r1, self.r2
        ) == (other.mprime, other.r1, other.r2)


def build_sm2_tables() -> Sm2Tables:
    """The port's own SM2 tables: its comb builder and its MontField."""
    F = limb.MontField(SM2_CURVE.p, "cpu")
    return Sm2Tables(
        comb_words=limbs16_to_words(ec.g_comb_table("sm2")),
        mprime=F.mprime_int,
        r1=F.r1_int,
        r2=F.r2_int,
    )


@lru_cache(maxsize=None)
def default_sm2_tables() -> Sm2Tables:
    return build_sm2_tables()


def sm2_tables_from_jax(g_comb_table_sm2: np.ndarray, mont_field) -> Sm2Tables:
    """Convert the JAX package's SM2 state to the port's layout.

    g_comb_table_sm2: [30, 16] uint32 16-bit limbs, as
    ``fisco_bcos_tpu.ops.ec.g_comb_table`` returns it for SM2.
    mont_field: an object with the JAX ``MontField`` fields ``mprime``,
    ``r1`` and ``r2`` as limb arrays, as ``make_mont_field(p)`` returns it.
    """
    table = np.asarray(g_comb_table_sm2)
    if table.shape != (30, 16):
        raise ValueError(f"SM2 comb table must be [30, 16], got {table.shape}")
    return Sm2Tables(
        comb_words=limbs16_to_words(table),
        mprime=_limbs_int(mont_field.mprime),
        r1=_limbs_int(mont_field.r1),
        r2=_limbs_int(mont_field.r2),
    )


ED25519_COMB_ENTRIES = 8  # c = 1..8: the kernel's signed 4-bit digits reach |d| = 8


@lru_cache(maxsize=None)
def ed25519_comb_words() -> np.ndarray:
    """The Ed25519 kernel's [24, 8] uint32 comb: rows 3c-3..3c-1 hold the
    words of (y+x, y-x, 2dxy) mod p of the affine c·B, c = 1..8 — the
    first 24 rows of :func:`~.ops.ed25519.b_comb_table`, which builds them
    from Python integers as the JAX package does."""
    from .ops.ed25519 import b_comb_table

    return limbs16_to_words(b_comb_table()[: 3 * ED25519_COMB_ENTRIES])
