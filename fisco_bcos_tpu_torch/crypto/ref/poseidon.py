"""Pure-Python Poseidon (2019/458) over the BN254 scalar field — the port's
copy of the JAX package's ``crypto/ref/poseidon.py``: the host oracle of the
port's batch Poseidon (``ops/poseidon.py``, ``csrc/poseidon.cu``) and its
single-message hash.

The SNARK-friendly hash the succinct state plane commits KeyPage state
under (``FISCO_STATE_HASH=poseidon``; 2407.03511: hash-verification
circuits are the first thing ZK blockchains optimize, so the commitment
hash must be circuit-cheap from day one).

Every parameter here is DERIVED, never transcribed: round constants come
out of the Grain LFSR exactly as the reference parameter generator
specifies, and the MDS matrix is the Cauchy construction 1/(x_i + y_j) —
``ops/poseidon.py`` re-asserts both over plain ints at import, so a
corrupted table cannot survive silently.

Instance: x^5 S-box, t = 3 (rate 2, capacity 1), 8 full + 57 partial rounds
— the standard 128-bit-security instance for this width/field.
"""

from __future__ import annotations

from functools import lru_cache

# BN254 (alt_bn128) scalar-field prime — the field Groth16/PLONK circuits
# natively compute in, hence the field the commitment hash must live in.
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

T = 3  # state width
ALPHA = 5  # S-box exponent (gcd(5, FR - 1) == 1)
R_FULL = 8  # full rounds (split 4 + 4 around the partial run)
R_PARTIAL = 57  # partial rounds
N_ROUNDS = R_FULL + R_PARTIAL
RATE = T - 1  # sponge rate in field elements
CHUNK = 31  # bytes absorbed per field element (248 bits < 254-bit field)
BLOCK_BYTES = RATE * CHUNK  # 62-byte absorb granule
_FIELD_BITS = FR.bit_length()  # 254

# x^5 is a permutation of GF(FR) iff gcd(5, FR - 1) == 1
assert (FR - 1) % ALPHA != 0


def _grain_bits(field_bits: int, t: int, r_f: int, r_p: int):
    """Grain LFSR keystream per the Poseidon reference parameter generator.

    80-bit init = [field tag=1 (prime field), sbox tag=0 (x^alpha), n, t,
    R_F, R_P, 30 ones], each big-endian; feedback b_{i+80} = b_{i+62} ^
    b_{i+51} ^ b_{i+38} ^ b_{i+23} ^ b_{i+13} ^ b_i; first 160 bits
    discarded; then bits are drawn in pairs — a 1 emits the partner bit, a
    0 discards it (the generator's rejection step).
    """
    bits: list[int] = []

    def put(value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            bits.append((value >> i) & 1)

    put(1, 2)  # GF(p)
    put(0, 4)  # x^alpha S-box
    put(field_bits, 12)
    put(t, 12)
    put(r_f, 10)
    put(r_p, 10)
    bits.extend([1] * 30)
    assert len(bits) == 80

    pos = 0

    def raw() -> int:
        nonlocal pos
        b = (
            bits[pos + 62]
            ^ bits[pos + 51]
            ^ bits[pos + 38]
            ^ bits[pos + 23]
            ^ bits[pos + 13]
            ^ bits[pos]
        )
        bits.append(b)
        pos += 1
        return b

    for _ in range(160):
        raw()
    while True:
        if raw():
            yield raw()
        else:
            raw()


def _sample_field(gen, count: int) -> list[int]:
    """Draw `count` field elements: 254 keystream bits big-endian, rejected
    and redrawn whenever the integer lands >= FR (no modular bias)."""
    out: list[int] = []
    while len(out) < count:
        v = 0
        for _ in range(_FIELD_BITS):
            v = (v << 1) | next(gen)
        if v < FR:
            out.append(v)
    return out


@lru_cache(maxsize=1)
def round_constants() -> tuple[tuple[int, ...], ...]:
    """[N_ROUNDS][T] Grain-derived round constants (ints < FR)."""
    gen = _grain_bits(_FIELD_BITS, T, R_FULL, R_PARTIAL)
    flat = _sample_field(gen, N_ROUNDS * T)
    return tuple(
        tuple(flat[r * T : (r + 1) * T]) for r in range(N_ROUNDS)
    )


@lru_cache(maxsize=1)
def mds_matrix() -> tuple[tuple[int, ...], ...]:
    """[T][T] Cauchy MDS: M[i][j] = 1/(x_i + y_j), x_i = i, y_j = T + j.

    x's and y's are pairwise distinct and x_i + y_j != 0, so the matrix is
    MDS over GF(FR); the invertibility of every entry IS the derivation —
    ops/poseidon.py asserts M[i][j] * (i + T + j) == 1 (mod FR)."""
    return tuple(
        tuple(pow(i + T + j, FR - 2, FR) for j in range(T)) for i in range(T)
    )


def _mix(state: list[int]) -> list[int]:
    m = mds_matrix()
    return [
        sum(m[i][j] * state[j] for j in range(T)) % FR for i in range(T)
    ]


def permutation(state) -> list[int]:
    """The Poseidon permutation over a T-element state of ints < FR."""
    if len(state) != T:
        raise ValueError("poseidon permutation wants a width-%d state" % T)
    state = [s % FR for s in state]
    rcs = round_constants()
    half = R_FULL // 2
    for rnd in range(N_ROUNDS):
        state = [(s + c) % FR for s, c in zip(state, rcs[rnd])]
        full = rnd < half or rnd >= half + R_PARTIAL
        if full:
            state = [pow(s, ALPHA, FR) for s in state]
        else:
            state[0] = pow(state[0], ALPHA, FR)
        state = _mix(state)
    return state


def pad_input(data: bytes) -> bytes:
    """Sponge padding: append 0x01, then zeros to a BLOCK_BYTES multiple.

    Injective over byte strings (the 0x01 marks the true end), and every
    31-byte chunk is < 2^248 < FR, so chunk -> field element is injective
    too."""
    padded = data + b"\x01"
    rem = len(padded) % BLOCK_BYTES
    if rem:
        padded += b"\x00" * (BLOCK_BYTES - rem)
    return padded


def absorb_elements(data: bytes) -> list[int]:
    """Padded input as the flat field-element sequence the sponge absorbs."""
    padded = pad_input(data)
    return [
        int.from_bytes(padded[i : i + CHUNK], "big")
        for i in range(0, len(padded), CHUNK)
    ]


def poseidon_hash(data: bytes) -> bytes:
    """Poseidon sponge hash: 32-byte big-endian digest (first state word)."""
    elems = absorb_elements(data)
    state = [0] * T
    for i in range(0, len(elems), RATE):
        for j in range(RATE):
            state[j] = (state[j] + elems[i + j]) % FR
        state = permutation(state)
    return state[0].to_bytes(32, "big")
