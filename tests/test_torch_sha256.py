"""SHA-256 in the port on the CPU: the plain packed version
(``ops/sha256.py``) against hashlib on every padding edge and on seeded
messages of 0-700 bytes, and once against the JAX package's
``sha256_batch`` at the 32-lane bucket; the kernel's arithmetic
(``csrc/sha256.cuh``) built with g++ and read through both routes of its
message reader against the plain version and hashlib, on every padding
edge alone and with a warp of messages of unequal lengths run to the
warp's longest; the ``Sha256`` HashImpl against the JAX ``Sha256``;
merkle roots with hasher ``"sha256"`` against a tree built with hashlib.
The kernel itself runs only on the card, through chip_smoke.py."""

import ctypes
import hashlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.ops import sha256 as jsha256
from fisco_bcos_tpu_torch.crypto import suite
from fisco_bcos_tpu_torch.crypto.ref.sha2 import sha256 as ref_sha256
from fisco_bcos_tpu_torch.ops import _kernels, hash_common, merkle, sha256

# tests/test_hash_kernels.py's LENGTHS: every 64-byte block's padding edge
LENGTHS = [0, 1, 31, 32, 54, 55, 56, 63, 64, 65, 119, 120, 135, 136, 137, 200, 272, 300]

SHIM = r"""
#include "{csrc}/sha256.cu"

// message i of the packed batch, read where it lies -> out[32 i ..]
extern "C" void host_sha256(const uint8_t* data, const int64_t* starts, const int32_t* lengths,
                            uint8_t* out, int n) {{
  for (int i = 0; i < n; i++) sha256_message(data + starts[i], lengths[i], out + 32 * i);
}}

static void put_digest(const uint32_t* v, uint8_t* out) {{
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)(v[j >> 2] >> (24 - 8 * (j & 3)));
}}

// the same through the staged route: message i at byte starts[i] of the
// 4-byte aligned words; every lane runs the blocks of the batch's longest
// message, as the lanes of one warp do
extern "C" void host_sha256_words(const uint32_t* words, const int64_t* starts,
                                  const int32_t* lengths, uint8_t* out, int n) {{
  uint32_t wb = 0;
  for (int i = 0; i < n; i++) {{
    const uint32_t nb = sha256_blocks_of((uint32_t)lengths[i]);
    wb = nb > wb ? nb : wb;
  }}
  for (int i = 0; i < n; i++) {{
    uint32_t v[8];
    sha256_lane(MsgReader::staged(words, (uint32_t)starts[i]), (uint32_t)lengths[i], wb, v);
    put_digest(v, out + 32 * i);
  }}
}}

"""


def _messages() -> list[bytes]:
    """The edge lengths, then seeded lengths of 0-700 bytes."""
    rng = np.random.default_rng(256)
    return [rng.bytes(int(n)) for n in LENGTHS + rng.integers(0, 701, 46).tolist()]


def _plain(msgs) -> np.ndarray:
    return sha256.sha256_packed(*(torch.from_numpy(a) for a in hash_common.pack_messages(msgs))).numpy()


@pytest.fixture(scope="module")
def host_sha256(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the SHA-256 kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("sha256_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(csrc=_kernels.CSRC))
    lib_path = d / "libsha256_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    for fn in (lib.host_sha256, lib.host_sha256_words):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
        fn.restype = None

    def run(data, starts, lengths, words=False) -> np.ndarray:
        """Digests [n, 32]: each read where it lies, its own blocks, or
        (words) staged, every lane to the batch's longest message's blocks."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        out = np.zeros((len(starts), 32), dtype=np.uint8)
        if words:  # 4-byte aligned, with the 12 bytes the reader may load past the end
            staged = np.concatenate([data, np.zeros(16 - data.size % 4, dtype=np.uint8)]).view(np.uint32)
            lib.host_sha256_words(staged.ctypes.data, starts.ctypes.data, lengths.ctypes.data,
                                  out.ctypes.data, len(starts))
        else:
            lib.host_sha256(data.ctypes.data, starts.ctypes.data, lengths.ctypes.data, out.ctypes.data,
                            len(starts))
        return out

    return run


def test_plain_matches_hashlib_on_every_edge():
    msgs = _messages()
    got = _plain(msgs)
    assert got.dtype == np.uint8 and got.shape == (len(msgs), 32)
    assert [bytes(g) for g in got] == [hashlib.sha256(m).digest() for m in msgs]
    assert _plain([]).shape == (0, 32)
    # the blocks form over the JAX padding (pad_md64, bucketed) gives the same
    blocks, nblocks = hash_common.pad_md64(msgs)
    words = sha256.sha256_blocks(torch.from_numpy(blocks.astype(np.int64)), torch.from_numpy(nblocks))
    want = hash_common.digest_words_to_bytes_be(words.numpy().astype(np.uint32))[: len(msgs)]
    np.testing.assert_array_equal(got, want)


def test_plain_matches_jax_sha256_batch():
    """The 18 edge messages, one JAX program at the 32-lane bucket."""
    rng = np.random.default_rng(18)
    msgs = [rng.bytes(n) for n in LENGTHS]
    np.testing.assert_array_equal(_plain(msgs), np.asarray(jsha256.sha256_batch(msgs)))


@pytest.mark.parametrize("layout", ["packed", "offsets", "rows", "merkle level"])
def test_kernel_arithmetic_on_host(host_sha256, layout):
    """The kernel's message function, read where a message lies and
    through the staged route's word reader, == the plain version ==
    hashlib: the packed sweep; its messages at every offset mod 16 in
    shuffled order; [B, 64] key rows; a merkle level's groups of 16
    nodes, the last one short."""
    rng = np.random.default_rng(7)
    if layout == "rows":
        rows = rng.integers(0, 256, (37, 64), dtype=np.uint8)
        data, starts, lengths = (t.numpy() for t in hash_common.rows_as_packed(torch.from_numpy(rows)))
    elif layout == "merkle level":
        data = rng.integers(0, 256, 37 * 32, dtype=np.uint8)
        first = np.arange(0, 37, 16)
        starts, lengths = first * 32, np.minimum(16, 37 - first) * 32
    else:
        msgs = _messages()
        gaps = rng.integers(0, 16, len(msgs)) if layout == "offsets" else np.zeros(len(msgs), int)
        data = np.frombuffer(b"".join(bytes(int(g)) + m for g, m in zip(gaps, msgs)), dtype=np.uint8)
        starts = np.cumsum([int(g) + len(m) for g, m in zip(gaps, msgs)]) - [len(m) for m in msgs]
        lengths = np.array([len(m) for m in msgs])
        order = rng.permutation(len(msgs)) if layout == "offsets" else np.arange(len(msgs))
        starts, lengths = starts[order], lengths[order]
    msgs = [data[s : s + n].tobytes() for s, n in zip(starts, lengths)]
    want = _plain(msgs)
    np.testing.assert_array_equal(host_sha256(data, starts, lengths), want)
    np.testing.assert_array_equal(host_sha256(data, starts, lengths, words=True), want)
    assert [bytes(w) for w in want] == [hashlib.sha256(m).digest() for m in msgs]


# every SHA-256 padding edge: one block (0, 1, 55), the length field
# spilling into a second (56, 63), a block exactly full (64), the same a
# block later (119, 120), and the mixed blocks' longest, 12 blocks (700)
PADDING_EDGES = (0, 1, 55, 56, 63, 64, 119, 120, 700)
# a warp of eight messages of unequal lengths, from 1 to 12 blocks
WARP_OF_EIGHT = (700, 0, 64, 55, 300, 120, 1, 513)
ROUTES = {"read where it lies": False, "staged words": True}


def _packed_at(msgs, rng):
    """msgs packed at seeded gaps of 0-15 bytes: (data, starts, lengths)."""
    gaps = rng.integers(0, 16, len(msgs))
    data = np.frombuffer(b"".join(bytes(int(g)) + m for g, m in zip(gaps, msgs)), dtype=np.uint8)
    lengths = np.array([len(m) for m in msgs])
    starts = np.cumsum([int(g) + len(m) for g, m in zip(gaps, msgs)]) - lengths
    return data, starts, lengths


@pytest.mark.parametrize("n", PADDING_EDGES)
def test_lane_on_each_padding_edge(host_sha256, n):
    """A message of each padding edge's length alone, through both routes,
    at each offset mod 4 of the staged words: its lane's full blocks load
    without the padding logic, its last one or two form it; == hashlib."""
    rng = np.random.default_rng(n)
    msg = rng.bytes(n)
    for gap in range(4):
        data = np.frombuffer(bytes(gap) + msg, dtype=np.uint8)
        for route, words in ROUTES.items():
            got = host_sha256(data, np.array([gap]), np.array([n]), words=words)
            assert bytes(got[0]) == hashlib.sha256(msg).digest(), (gap, route)


@pytest.mark.parametrize("route", ROUTES)
def test_lane_a_warp_of_eight_lengths(host_sha256, route):
    """Eight messages of 1-12 blocks run as one warp (every lane to the
    longest message's blocks, compressing zeros past its own) == hashlib."""
    rng = np.random.default_rng(8)
    msgs = [rng.bytes(n) for n in WARP_OF_EIGHT]
    data, starts, lengths = _packed_at(msgs, rng)
    got = host_sha256(data, starts, lengths, words=ROUTES[route])
    assert [bytes(g) for g in got] == [hashlib.sha256(m).digest() for m in msgs]


def test_kernel_source_design_and_constants():
    """The kernel body of its own (no longer the shared packed hash body):
    one lane a message through sha256_lane, the warp to its longest
    message's blocks, each message through one MsgReader (one copy of the
    compression, its 64 rounds unrolled), the launch's CUDA error
    returned, the geometry exported, and K and the IV equal to the plain
    version's copies."""
    src = _kernels.SOURCES["sha256"].read_text()
    header = (_kernels.CSRC / "sha256.cuh").read_text()
    assert '#include "sha256.cuh"' in src and '#include "hash_kernel.cuh"' in header
    assert "__global__ void __launch_bounds__(HASH_THREADS)\nsha256_kernel(" in src
    assert "packed_hash_launch<Sha256" not in src and "struct Sha256" not in header
    assert "sha256_lane(msg, valid ? (uint32_t)len : 0u, wb, v)" in src
    assert "__reduce_max_sync" in src and "warp_meet();" in header
    assert "MsgReader::staged(" in src and "MsgReader::direct(" in src
    assert "sha256_compress(u, w);" in header and "for (int j = 16; j < 64; j++)" in header
    assert "SHA256_LANES" not in src and "#pragma unroll 1\n  for (int t0" not in header
    assert 'extern "C" int sha256_launch(' in src and 'extern "C" void sha256_geometry(' in src
    for name, table in (("SHA256_K", sha256._K), ("SHA256_IV", sha256._IV)):
        body = re.search(r"%s\[\d+\] = \{([^}]*)\}" % name, header).group(1)
        assert [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()] == table
    assert _kernels.KERNELS["sha256_packed"] == "sha256"


def test_sha256_hash_impl_matches_jax():
    impl, ref = suite.hash_impl_by_name("sha256"), jsuite.Sha256()
    assert isinstance(impl, suite.Sha256) and impl.name == ref.name == "sha256"
    msgs = _messages()[:24]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda n: pytest.fail("kernel loader called on CPU"))
        got = impl.hash_batch(msgs, device="cpu")
        got_async = impl.hash_batch_async(iter(msgs), device="cpu")()
        keys = np.random.default_rng(64).integers(0, 256, (9, 64), dtype=np.uint8)
        addresses = suite.Sha256(torch.device("cpu")).address_batch(keys)
    np.testing.assert_array_equal(got, got_async)
    for i, m in enumerate(msgs):
        assert bytes(got[i]) == ref.hash(m) == impl.hash(m) == ref_sha256(m), len(m)
    assert [bytes(a) for a in addresses] == [ref.hash(bytes(k))[12:] for k in keys]
    assert impl.hash_batch([], device="cpu").shape == (0, 32)


def _oracle_root(leaves: np.ndarray, width: int = 16) -> bytes:
    """merkle_root's definition with hashlib: leaves zero-filled to their
    bucket, groups of `width`, H(padded root ‖ u64be(n))."""
    n = len(leaves)
    level = [bytes(x) for x in leaves] + [bytes(32)] * (merkle.bucket_leaves(n) - n)
    while len(level) > 1:
        level = [ref_sha256(b"".join(level[i : i + width])) for i in range(0, len(level), width)]
    return ref_sha256(level[0] + n.to_bytes(8, "big"))


@pytest.mark.parametrize("n", [1, 2, 16, 17, 300])
def test_merkle_root_with_sha256(n):
    leaves = np.random.default_rng(n).integers(0, 256, (n, 32), dtype=np.uint8)
    root = merkle.merkle_root(leaves, hasher="sha256", device="cpu")
    assert root == _oracle_root(leaves)
    tree = merkle.MerkleTree(leaves, hasher="sha256", device="cpu")
    assert tree.root == root
    i = n // 2
    assert merkle.MerkleTree.verify_proof(bytes(leaves[i]), i, n, tree.proof(i), root, hasher="sha256")
