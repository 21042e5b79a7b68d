"""Batch Poseidon over the BN254 scalar field (2019/458; t = 3, rate 2,
x^5, 8 full + 57 partial rounds): the hand-written CUDA kernel and its plain
PyTorch version. The succinct state plane's commitment hasher
(``FISCO_STATE_HASH=poseidon``).

:func:`poseidon_packed` hashes a packed batch (one byte buffer, per-message
starts and lengths; ``hash_common.pack_messages``): on a CUDA tensor it
launches ``csrc/poseidon.cu``, which pads, cuts and encodes each message
itself; on a CPU tensor it runs :func:`poseidon_packed_plain`, which pads on
the tensor's device (:func:`absorb_limbs`: 0x01, zeros to a 62-byte
multiple, each 31-byte chunk a big-endian field element) and runs the
sponge below.

The sponge is the port of the JAX package's ``poseidon_blocks``: state words
in the Montgomery domain of ``limb.MontField(FR)``, ``[16, B]`` int64 limbs,
lanes absorbing their own number of blocks. Its partial rounds box word 0
alone (the JAX scan boxes all three and keeps word 0's result, the same
output).

Every constant is DERIVED from the port's oracle (``crypto/ref/poseidon.py``:
Grain LFSR round constants, Cauchy MDS) and re-asserted over plain ints at
import: no transcribed table, and a corrupted constant fails the import.
The kernel takes them from :data:`KERNEL_TABLE`, built from the same tables.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F_nn

from . import _kernels
from ..crypto.ref import poseidon as ref
from ..device import resolve_device
from ..observability.device import device_span
from .hash_common import bucket_batch, download_later, gather_padded, upload_packed
from .limb import LIMBS, MontField

FR = ref.FR
T = ref.T
RATE = ref.RATE
CHUNK = ref.CHUNK
BLOCK_BYTES = ref.BLOCK_BYTES
N_ROUNDS = ref.N_ROUNDS
_R = 1 << 256

_F = MontField(FR, "cpu")  # host encodings; the sponge takes the tensor's device's

# ---------------------------------------------------------------------------
# Derived constant tables (Montgomery domain), asserted against the oracle's
# derivation over plain ints at import
# ---------------------------------------------------------------------------

_REF_RC = ref.round_constants()
_REF_MDS = ref.mds_matrix()

assert len(_REF_RC) == N_ROUNDS and all(len(r) == T for r in _REF_RC)
assert all(0 <= c < FR for row in _REF_RC for c in row)
for _i in range(T):
    for _j in range(T):
        # the Cauchy property IS the derivation: M[i][j] = 1/(x_i + y_j)
        assert _REF_MDS[_i][_j] * (_i + T + _j) % FR == 1

# [N_ROUNDS, T, 16] Montgomery-encoded round constants, 16-bit limbs
_RC_MONT = np.stack([np.stack([_F.enc(c) for c in row]) for row in _REF_RC])
# [T, T, 16] Montgomery-encoded MDS entries
_MDS_MONT = np.stack([np.stack([_F.enc(m) for m in row]) for row in _REF_MDS])
# per-round S-box flag (1 = all words, 0 = word 0 only): 4 full, 57 partial, 4 full
_HALF = ref.R_FULL // 2
_FULL_FLAG = np.array(
    [1 if (r < _HALF or r >= _HALF + ref.R_PARTIAL) else 0 for r in range(N_ROUNDS)],
    dtype=np.int64,
)
assert int(_FULL_FLAG.sum()) == ref.R_FULL and _FULL_FLAG[0] == 1 and _FULL_FLAG[_HALF] == 0


def _limbs_int(limbs) -> int:
    return sum(int(v) << (16 * k) for k, v in enumerate(limbs))


# Montgomery round trip: decoding every encoded entry recovers the oracle's
# int (guards a silent enc or limb-layout regression)
_RINV = pow(_R, -1, FR)
assert all(
    _limbs_int(_RC_MONT[r, i]) * _RINV % FR == _REF_RC[r][i] for r in range(N_ROUNDS) for i in range(T)
)
assert all(_limbs_int(_MDS_MONT[i, j]) * _RINV % FR == _REF_MDS[i][j] for i in range(T) for j in range(T))


# ---------------------------------------------------------------------------
# The sparse partial-round form (eprint 2019/458, Appendix B), the kernel's:
# the same permutation with a sparse mix in every partial round
# ---------------------------------------------------------------------------


def _mat_mul(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(len(b))) % FR for j in range(len(b[0]))]
            for i in range(len(a))]


def _mat_vec(a, v):
    return [sum(a[i][k] * v[k] for k in range(len(v))) % FR for i in range(len(a))]


def _mat_inv(a):
    """The inverse of a square matrix over GF(FR), by Gauss-Jordan."""
    n = len(a)
    m = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for c in range(n):
        p = next(r for r in range(c, n) if m[r][c])
        m[c], m[p] = m[p], m[c]
        inv = pow(m[c][c], -1, FR)
        m[c] = [x * inv % FR for x in m[c]]
        for r in range(n):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(x - f * y) % FR for x, y in zip(m[r], m[c])]
    return [row[n:] for row in m]


def _sparse_form():
    """The instance in the form the kernel runs, over plain ints:
    (start constants [T], mixes [N_ROUNDS][T][T], end constants
    [N_ROUNDS][T]). Round r boxes its words (all of them in a full round,
    word 0 in a partial one), mixes by mixes[r], then adds end[r]; the
    start constants are added before round 0.

    Derived from the oracle's constants and MDS in two steps:
      1. constants moved: a partial round's constant on words 1 and 2 goes
         through the round before it (M^-1, then past the S-box, which
         leaves those words alone), so each partial round after the first
         keeps one scalar k_r, added to word 0 after its S-box;
      2. matrices factored, last partial round first: its mix N = S·P with
         P = diag(1, N̂) (N̂ the lower-right 2x2) and S = [[n00, v], [w,
         I]] sparse; P commutes with the S-box on word 0 and with k_r, so it
         moves into the round before (N = P·M there); the first partial
         round's P reaches the last full round of the first half (its mix
         becomes P·M, and the first partial round's constants P·c).
    Then k_r is moved past S_r into the end constants: S_r·(k_r, 0, 0)."""
    mds = [list(r) for r in _REF_MDS]
    c = [list(r) for r in _REF_RC]
    first, last = _HALF, _HALF + ref.R_PARTIAL - 1  # the partial rounds' span
    m_inv = _mat_inv(mds)
    k = [0] * N_ROUNDS
    for i in range(last - 1, first - 1, -1):  # step 1
        u = _mat_vec(m_inv, c[i + 1])
        c[i] = [c[i][0], (c[i][1] + u[1]) % FR, (c[i][2] + u[2]) % FR]
        k[i], c[i + 1] = u[0], [0] * T
    mixes = [mds] * N_ROUNDS
    n = mds
    for r in range(last, first - 1, -1):  # step 2
        b = [row[1:] for row in n[1:]]
        v = _mat_mul([n[0][1:]], _mat_inv(b))[0]
        mixes[r] = [[n[0][0]] + v, [n[1][0], 1, 0], [n[2][0], 0, 1]]
        p = [[1, 0, 0], [0] + b[0], [0] + b[1]]
        n = _mat_mul(p, mds)
    mixes[first - 1] = n
    c[first] = _mat_vec(p, c[first])
    end = [[0] * T for _ in range(N_ROUNDS)]
    for r in range(N_ROUNDS):
        nxt = c[r + 1] if r + 1 < N_ROUNDS else [0] * T  # moved partial rounds' are zero
        moved = [k[r] * mixes[r][i][0] % FR for i in range(T)]
        end[r] = [(x + y) % FR for x, y in zip(nxt, moved)]
    return c[0], mixes, end


_SPARSE_START, _SPARSE_MIX, _SPARSE_END = _sparse_form()


def sparse_permutation(state) -> list[int]:
    """The permutation over plain ints in the sparse form the kernel runs
    (:func:`_sparse_form`); equals ``ref.permutation``."""
    s = [(x + c) % FR for x, c in zip(state, _SPARSE_START)]
    for r in range(N_ROUNDS):
        s = [pow(x, ref.ALPHA, FR) for x in s] if _FULL_FLAG[r] else [pow(s[0], ref.ALPHA, FR)] + s[1:]
        s = [(x + e) % FR for x, e in zip(_mat_vec(_SPARSE_MIX[r], s), _SPARSE_END[r])]
    return s


# partial rounds mix sparsely: [[a, v1, v2], [w1, 1, 0], [w2, 0, 1]]
assert all(_SPARSE_MIX[r][1][1:] == [1, 0] and _SPARSE_MIX[r][2][1:] == [0, 1]
           for r in range(N_ROUNDS) if not _FULL_FLAG[r])
for _s in ([0, 0, 0], [1, 2, 3], [FR - 1, 5, 0]):
    assert sparse_permutation(_s) == ref.permutation(_s)


def _words(v: int) -> list[int]:
    """A value < 2^256 as 8 little-endian 32-bit words."""
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


# csrc/poseidon.cu's PT_* layout, in 32-bit words: FR, n0 = -FR^-1 mod 2^32
# and 7 zero words, zero, R^2 mod FR, the start constants [3], a block of 12
# values a round ([65]: its end constants [3], then its mix [3][3] row by
# row), the full-round flags [65], 3 zero words. Values are 8 words each, in
# the Montgomery domain but FR, n0, zero and R^2.
TABLE_ROUND_VALUES = T + T * T  # 3 end constants + 9 mix entries
TABLE_LAYOUT = {"fr": 0, "n0": 8, "zero": 16, "r2": 24, "start": 32, "rounds": 56}
TABLE_LAYOUT["full"] = TABLE_LAYOUT["rounds"] + N_ROUNDS * TABLE_ROUND_VALUES * 8
TABLE_WORDS = TABLE_LAYOUT["full"] + N_ROUNDS + 3


def _mont_words(v: int) -> list[int]:
    return _words(v * _R % FR)


def _kernel_table() -> np.ndarray:
    """The kernel's constants (csrc/poseidon.cu's PT_* layout, above) as
    int32 words, from the sparse form."""
    words = _words(FR) + [(-pow(FR, -1, 1 << 32)) % (1 << 32)] + [0] * 7 + [0] * 8 + _words(_F.r2_int)
    words += [w for c in _SPARSE_START for w in _mont_words(c)]
    for r in range(N_ROUNDS):
        values = list(_SPARSE_END[r]) + [m for row in _SPARSE_MIX[r] for m in row]
        words += [w for v in values for w in _mont_words(v)]
    words += [int(f) for f in _FULL_FLAG] + [0] * 3
    return np.array(words, dtype=np.uint32).view(np.int32)


KERNEL_TABLE = _kernel_table()
assert KERNEL_TABLE.size == TABLE_WORDS and KERNEL_TABLE.size % 4 == 0
assert (int(KERNEL_TABLE[TABLE_LAYOUT["n0"]]) * FR) % (1 << 32) == (1 << 32) - 1  # n0·FR ≡ -1


@lru_cache(maxsize=None)
def kernel_table(device: torch.device) -> torch.Tensor:
    """:data:`KERNEL_TABLE` on `device`, uploaded once per device."""
    return torch.from_numpy(KERNEL_TABLE).to(device)


@lru_cache(maxsize=None)
def _consts(device: torch.device):
    """(MontField(FR), round constants [N_ROUNDS, T, 16], MDS [T, T, 16])
    on `device`."""
    return (
        MontField(FR, device),
        torch.from_numpy(_RC_MONT).to(device),
        torch.from_numpy(_MDS_MONT).to(device),
    )


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _sbox(F: MontField, x: torch.Tensor) -> torch.Tensor:
    """x^5 = (x^2)^2 * x: 2 squarings + 1 mul."""
    return F.mul(F.sqr(F.sqr(x)), x)


def permute_lanes(state: tuple) -> tuple:
    """The permutation over a T-tuple of [16, B] Montgomery-domain words."""
    F, rc, mds = _consts(state[0].device)
    s = list(state)
    for rnd in range(N_ROUNDS):
        s = [F.add(s[i], rc[rnd, i][:, None]) for i in range(T)]
        s = [_sbox(F, x) for x in s] if _FULL_FLAG[rnd] else [_sbox(F, s[0])] + s[1:]
        out = []
        for i in range(T):
            acc = F.mul(s[0], mds[i, 0][:, None])
            for j in range(1, T):
                acc = F.add(acc, F.mul(s[j], mds[i, j][:, None]))
            out.append(acc)
        s = out
    return tuple(s)


def poseidon_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Sponge over padded, Montgomery-encoded blocks (the JAX layout):
    blocks [B, M, RATE, 16] limbs (any integer dtype), nblocks [B]. Returns
    the squeezed word as [16, B] PLAIN-domain int64 limbs.

    Block slot m permutes only the lanes that absorb it (nblocks > m); the
    others keep their state, as the JAX program's mask keeps it."""
    dev = blocks.device
    F = _consts(dev)[0]
    b = blocks.to(torch.int64)
    nblocks = nblocks.to(dev)
    bsz = b.shape[0]
    state = [torch.zeros((LIMBS, bsz), dtype=torch.int64, device=dev) for _ in range(T)]
    m_used = min(int(nblocks.max()) if bsz else 0, b.shape[1])
    for m in range(m_used):
        idx = torch.nonzero(nblocks > m).squeeze(1)
        s = [x[:, idx] for x in state]
        for j in range(RATE):
            s[j] = F.add(s[j], b[idx, m, j, :].T)
        new = permute_lanes(tuple(s))
        state = [x.index_copy(1, idx, y) for x, y in zip(state, new)]
    return F.to_plain(state[0])


def absorb_limbs(data, starts, lengths) -> tuple[torch.Tensor, torch.Tensor]:
    """The sponge padding of each message of a packed batch (data uint8 [N],
    starts int64 [B], lengths int32 [B]), on the inputs' device: 0x01, then
    zeros to a 62-byte multiple, each 31-byte chunk read big-endian. Returns
    (elements [B, M, RATE, 16] int64 PLAIN 16-bit limbs, nblocks [B]
    int64), M the largest block count; a lane's slots past its own count
    are zero."""
    bsz = starts.shape[0]
    lengths = lengths.to(torch.int64)
    nblocks = lengths // BLOCK_BYTES + 1
    buf = gather_padded(data, starts, lengths, BLOCK_BYTES, nblocks)
    pos = torch.arange(buf.shape[1], device=data.device)
    buf |= (pos == lengths[:, None]).to(torch.int64)
    # each chunk's bytes little-endian, one zero byte on top: 16 16-bit limbs
    le = F_nn.pad(buf.view(bsz, -1, RATE, CHUNK).flip(-1), (0, 1))
    return le[..., 0::2] | (le[..., 1::2] << 8), nblocks


def limbs_be_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """[16, B] little-endian 16-bit limbs -> [B, 32] uint8, the value's bytes
    big-endian."""
    be = limbs.T.flip(-1)  # [B, 16], most significant limb first
    return torch.stack([be >> 8, be & 0xFF], dim=-1).reshape(-1, 32).to(torch.uint8)


def poseidon_packed_plain(data, starts, lengths) -> torch.Tensor:
    """The plain PyTorch version of the kernel: Poseidon of each message of
    a packed batch (data uint8 [N], starts int64 [B], lengths int32 [B]) ->
    [B, 32] uint8 big-endian digests, on the inputs' device."""
    if starts.shape[0] == 0:
        return torch.empty((0, 32), dtype=torch.uint8, device=data.device)
    F = _consts(data.device)[0]
    elems, nblocks = absorb_limbs(data, starts, lengths)
    bsz, m = elems.shape[:2]
    mont = F.from_plain(elems.reshape(-1, LIMBS).T).T.reshape(bsz, m, RATE, LIMBS)
    return limbs_be_bytes(poseidon_blocks(mont, nblocks))


def poseidon_packed(data, starts, lengths) -> torch.Tensor:
    """Poseidon of each message of a packed batch -> [B, 32] uint8. CUDA
    tensors go to the kernel (or an exception); CPU tensors to the plain
    version."""
    if data.device.type == "cuda":
        return _kernels.poseidon_packed(data, starts, lengths, kernel_table(data.device))
    if data.device.type == "cpu":
        return poseidon_packed_plain(data, starts, lengths)
    raise ValueError(f"poseidon_packed: unsupported device {data.device}")


def poseidon_batch(msgs, device=None) -> np.ndarray:
    """Host convenience: list of bytes -> [B, 32] uint8 digests. Runs on the
    CUDA card unless ``device`` names another; one ``poseidon`` span."""
    n = len(msgs)
    with device_span("poseidon", n, shape_key=bucket_batch(n)):
        return poseidon_batch_async(msgs, device)()


def poseidon_batch_async(msgs, device=None):
    """Dispatch the batch and defer the copy to the host: returns a resolver
    () -> [B, 32] uint8."""
    return download_later(poseidon_packed(*upload_packed(msgs, resolve_device(device))))
