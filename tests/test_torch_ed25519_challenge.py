"""The Ed25519 challenges, k_neg = (L - SHA-512(R ‖ A ‖ M) mod L) mod L
written into bytes 96..127 of each lane's row: the CUDA kernel's arithmetic
(csrc/ed25519_challenge.cu) built as host C++, through both routes of its
message reader, a warp of messages of unequal lengths at a time, and the
plain PyTorch version (ops/ed25519.py challenge_plain), against hashlib
and Python integers (ops/ed25519.py challenges, the oracle), on seeded
messages of 0-300 bytes with every SHA-512 padding edge after the 64-byte
prefix; the Barrett reduction mod L alone on its edges;
and the rows as the verify path makes them against device_inputs, the
bucket's zero rows included. No JAX program is traced; the kernel itself
runs only on the card, through chip_smoke.py."""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref
from fisco_bcos_tpu_torch.ops import _kernels, ed25519
from fisco_bcos_tpu_torch.ops.hash_common import pack_messages, upload_packed

L = ref.L
KERNEL_SRC = _kernels.SOURCES["ed25519_challenge"]
# with the 64-byte prefix, 47/48/49 spill the length field into a second
# block, 63/64/65 fill the first block exactly, 175/176 and 191/192 the same
# for a third block
EDGE_LENGTHS = (0, 1, 32, 47, 48, 49, 63, 64, 65, 111, 112, 175, 176, 191, 192, 255, 256, 300)


def _batch(n: int = 48, seed: int = 0xC4A1):
    """(msgs, pubs, sigs): every edge length, then seeded lengths in 0..300;
    keys and signatures are random bytes (the challenge reads R and A as
    bytes, valid points or not)."""
    rng = random.Random(seed)
    lengths = list(EDGE_LENGTHS) + [rng.randrange(301) for _ in range(n - len(EDGE_LENGTHS))]
    msgs = [rng.randbytes(k) for k in lengths]
    return msgs, [rng.randbytes(32) for _ in msgs], [rng.randbytes(64) for _ in msgs]


def _oracle(msgs, pubs, sigs) -> list[bytes]:
    return [((L - int.from_bytes(ref._sha512(s[:32] + p + m), "little") % L) % L).to_bytes(32, "little")
            for m, p, s in zip(msgs, pubs, sigs)]


SHIM = r"""
#include "{src}"

static void lane_words(const uint8_t* row, uint32_t* ra) {{  // R, then A, as little-endian words
  for (int q = 0; q < 16; q++) {{
    const uint8_t* b = row + (q < 8 ? 4 * q : 64 + 4 * (q - 8));
    ra[q] = b[0] | b[1] << 8 | b[2] << 16 | (uint32_t)b[3] << 24;
  }}
}}

static void put(const uint32_t* k, uint8_t* out) {{
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)(k[j >> 2] >> (8 * (j & 3)));
}}

static MsgReader reader(const uint8_t* data, const uint32_t* words, int64_t start) {{
  return words ? MsgReader::staged(words, (uint32_t)start) : MsgReader::direct(data + start);
}}

// rows[i] gains message i's k_neg; words: the packed data as 4-byte aligned
// words (the staged route, every lane running the blocks of the batch's
// longest message, as the lanes of a warp do) or null (each message read
// where it lies, its own blocks)
extern "C" void host_challenge(uint8_t* rows, const uint8_t* data, const uint32_t* words,
                               const int64_t* starts, const int32_t* lengths, int n) {{
  uint32_t wb = 0;
  for (int i = 0; i < n; i++) {{
    const uint32_t nb = sha512_blocks_of((uint32_t)lengths[i]);
    wb = nb > wb ? nb : wb;
  }}
  for (int i = 0; i < n; i++) {{
    uint32_t ra[16], k[8];
    lane_words(rows + ED25519_ROW_BYTES * i, ra);
    challenge_lane(ra, reader(data, words, starts[i]), (uint32_t)lengths[i],
                   words ? wb : sha512_blocks_of((uint32_t)lengths[i]), k);
    put(k, rows + ED25519_ROW_BYTES * i + 96);
  }}
}}

extern "C" void host_mod_l(const uint32_t* x, uint32_t* r) {{ mod_l(x, r); }}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The challenge kernel's arithmetic compiled as host C++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("ed25519_challenge_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(src=KERNEL_SRC))
    lib_path = d / "libchallenge_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_challenge.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    lib.host_mod_l.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _host_rows(lib, msgs, pubs, sigs, staged: bool) -> np.ndarray:
    rows = ed25519.signature_rows(pubs, sigs)
    data, starts, lengths = pack_messages(msgs)
    words = None
    if staged:  # the data as words, with the 12 bytes past its end a reader may load
        padded = np.zeros(-(-(len(data) + 12) // 4) * 4, np.uint8)
        padded[: len(data)] = data
        words = padded.view(np.uint32)
    data = np.ascontiguousarray(data) if len(data) else np.zeros(1, np.uint8)
    lib.host_challenge(rows.ctypes.data, data.ctypes.data, None if words is None else words.ctypes.data,
                       starts.ctypes.data, lengths.ctypes.data, len(msgs))
    return rows


@pytest.mark.parametrize("staged", [False, True], ids=["read where it lies", "staged words"])
def test_kernel_challenge_on_host_matches_hashlib(host_lib, staged):
    msgs, pubs, sigs = _batch()
    rows = _host_rows(host_lib, msgs, pubs, sigs, staged)
    assert [bytes(r[96:]) for r in rows[: len(msgs)]] == _oracle(msgs, pubs, sigs)


# eight of the edge lengths, 1 to 3 blocks, run as one warp
WARP_OF_EIGHT = (300, 0, 47, 48, 176, 32, 111, 192)


@pytest.mark.parametrize("staged", [False, True], ids=["read where it lies", "staged words"])
def test_a_warp_of_eight_lengths_on_host(host_lib, staged):
    """Eight messages of 0-300 bytes (1-3 blocks) run as one warp, every
    lane to the longest message's blocks on the staged route, == hashlib."""
    rng = random.Random(8)
    msgs = [rng.randbytes(n) for n in WARP_OF_EIGHT]
    pubs, sigs = [rng.randbytes(32) for _ in msgs], [rng.randbytes(64) for _ in msgs]
    rows = _host_rows(host_lib, msgs, pubs, sigs, staged)
    assert [bytes(r[96:]) for r in rows[: len(msgs)]] == _oracle(msgs, pubs, sigs)


def test_lane_on_each_edge_length_alone(host_lib):
    """A message of each SHA-512 padding edge's length (after the 64-byte
    prefix) alone, its lane running only its own blocks, through both
    routes: full blocks load without the padding logic, the last one or
    two form it; == hashlib."""
    for n in EDGE_LENGTHS:
        rng = random.Random(n)
        msgs, pubs, sigs = [rng.randbytes(n)], [rng.randbytes(32)], [rng.randbytes(64)]
        for staged in (False, True):
            rows = _host_rows(host_lib, msgs, pubs, sigs, staged)
            assert bytes(rows[0][96:]) == _oracle(msgs, pubs, sigs)[0], (n, staged)


def test_kernel_reduction_mod_l_on_host(host_lib):
    """Barrett mod L on 0, L - 1, L, L + 1, q·L + r for large q, 2^512 - 1,
    the largest multiple of L below 2^512 and seeded 512-bit values."""
    rng = random.Random(0x1)
    top = ((1 << 512) - 1) // L * L
    values = [0, L - 1, L, L + 1, 2 * L - 1, 2 * L, (1 << 259) * L + 12345, top, top - 1, (1 << 512) - 1]
    values += [rng.getrandbits(512) for _ in range(200)]
    out = np.zeros(8, np.uint32)
    for x in values:
        words = np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(16)], np.uint32)
        host_lib.host_mod_l(words.ctypes.data, out.ctypes.data)
        assert sum(int(w) << (32 * i) for i, w in enumerate(out)) == x % L, hex(x)


def test_plain_challenge_matches_hashlib():
    msgs, pubs, sigs = _batch()
    rows = torch.from_numpy(ed25519.signature_rows(pubs, sigs))
    got = ed25519.challenge_plain(rows, *upload_packed(msgs, "cpu"))
    assert got is rows
    assert [bytes(r[96:]) for r in rows[: len(msgs)].numpy()] == _oracle(msgs, pubs, sigs)


def test_rows_after_the_challenge_equal_device_inputs(host_lib, monkeypatch):
    """The rows the verify path builds (R ‖ S ‖ A joined, k_neg written by
    the challenge) equal the host's device_inputs byte for byte, the
    bucket's zero rows included: from the plain version (challenge_rows on
    the CPU, which must not reach the kernel loader) and from the host
    build."""
    msgs, pubs, sigs = _batch(n=45)  # a 64-row bucket: 19 zero rows
    want = ed25519.device_inputs(msgs, pubs, sigs)
    assert want.shape == (64, ed25519.ROW_BYTES) and not want[len(msgs):].any()
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
    np.testing.assert_array_equal(ed25519.challenge_rows(msgs, pubs, sigs, device="cpu").numpy(), want)
    np.testing.assert_array_equal(_host_rows(host_lib, msgs, pubs, sigs, staged=False), want)


def test_signature_rows_layout():
    """R ‖ S ‖ A ‖ zeros a lane from lists (longer items cut to their first
    bytes) or [B, n] arrays; short keys or signatures and unequal counts
    raise."""
    _, pubs, sigs = _batch(n=20)
    rows = ed25519.signature_rows([p + b"tail" for p in pubs], [s + bytes(32) for s in sigs], pad_to=24)
    assert rows.shape == (24, ed25519.ROW_BYTES) and not rows[20:].any() and not rows[:, 96:].any()
    for row, p, s in zip(rows, pubs, sigs):
        assert bytes(row[:96]) == s + p
    arrays = ed25519.signature_rows(np.frombuffer(b"".join(pubs), np.uint8).reshape(20, 32),
                                    np.frombuffer(b"".join(sigs), np.uint8).reshape(20, 64), pad_to=24)
    np.testing.assert_array_equal(arrays, rows)
    for bad_pubs, bad_sigs in (([p[:31] for p in pubs], sigs), (pubs, [s[:63] for s in sigs]), (pubs[1:], sigs)):
        with pytest.raises(ValueError):
            ed25519.signature_rows(bad_pubs, bad_sigs)
