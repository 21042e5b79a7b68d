"""Poseidon in the port on the CPU: the port's oracle against the JAX
package's on every 31/62-byte edge; the derived tables against the JAX
module's ``_RC_MONT``, ``_MDS_MONT`` and ``_FULL_FLAG``; the plain packed
version (``ops/poseidon.py``) against the JAX oracle and its padding against
the JAX ``pad_poseidon``; merkle roots with hasher ``"poseidon"`` against the
JAX state plane's independent walker; the ``Poseidon`` HashImpl through the
DevicePlane against its direct call; and the kernel's arithmetic
(``csrc/poseidon.cu``) built with g++: its Montgomery product, squaring, MDS
row and permutation against Python integers and the oracle. No JAX program
is traced (the JAX sponge's XLA-CPU compile takes minutes); the kernel
itself runs only on the card, through chip_smoke.py."""

import ctypes
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto.ref import poseidon as jref
from fisco_bcos_tpu.ops import poseidon as jposeidon
from fisco_bcos_tpu.succinct.state_plane import _ref_tree_root
from fisco_bcos_tpu_torch.crypto import suite
from fisco_bcos_tpu_torch.crypto.ref import poseidon as ref
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.device.plane import DevicePlane
from fisco_bcos_tpu_torch.ops import _kernels, hash_common, merkle, poseidon

FR = ref.FR
R = 1 << 256
R_INV = pow(R, -1, FR)
# every chunk (31) and block (62) edge, up to four blocks
LENGTHS = [0, 1, 30, 31, 32, 61, 62, 63, 92, 93, 94, 123, 124, 125, 185, 186, 187, 200]

SHIM = r"""
#include "{csrc}/poseidon.cu"

// lane i: r[8i..] = op(a[8i..], b[8i..]): 0 fr_mul, 1 fr_sqr (of a), 2 the
// MDS row of b[24i..] (three entries) against the state a[24i..]
extern "C" void host_fr_op(int op, const u32* a, const u32* b, const u32* table, u32* r, int n) {{
  const u32* p = table + PT_FR;
  const u32 n0 = table[PT_N0];
  for (int i = 0; i < n; i++) {{
    if (op == 0) fr_mul(r + 8 * i, a + 8 * i, b + 8 * i, p, n0);
    if (op == 1) fr_sqr(r + 8 * i, a + 8 * i, p, n0);
    if (op == 2) fr_mds_row(r + 8 * i, b + 24 * i, a + 24 * i, a + 24 * i + 8, a + 24 * i + 16, p, n0);
  }}
}}

// lane i: the permutation of the Montgomery-domain state s[24i..], in place
extern "C" void host_permute(u32* s, const u32* table, int n) {{
  for (int i = 0; i < n; i++) {{
    u32* w = s + 24 * i;
    poseidon_permute(w, w + 8, w + 16, table, table + PT_FR, table[PT_N0]);
  }}
}}

// message i of the packed batch -> out[32 i ..], the digest as the kernel stores it
extern "C" void host_poseidon(const uint8_t* data, const int64_t* starts, const int32_t* lengths,
                              const u32* table, uint8_t* out, int n) {{
  for (int i = 0; i < n; i++) {{
    u32 d[8];
    poseidon_message(data + starts[i], lengths[i], table, d);
    for (int j = 0; j < 32; j++) out[32 * i + j] = (uint8_t)(d[j >> 2] >> (8 * (j & 3)));
  }}
}}

extern "C" int host_table_words() {{ return PT_WORDS; }}
"""


def _messages() -> list[bytes]:
    rng = np.random.default_rng(31)
    return [rng.bytes(n) for n in LENGTHS]


def _packed(msgs):
    return tuple(torch.from_numpy(a) for a in hash_common.pack_messages(msgs))


def _words(vals: list[int], width: int = 8) -> np.ndarray:
    return np.ascontiguousarray(
        [[(v >> (32 * k)) & 0xFFFFFFFF for k in range(width)] for v in vals], dtype=np.uint32
    )


def _ints(words: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * k) for k, w in enumerate(row)) for row in words.reshape(-1, 8)]


@pytest.fixture(autouse=True)
def no_kernel_loader(monkeypatch):
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))


def test_oracle_matches_the_jax_oracle():
    assert (ref.FR, ref.T, ref.RATE, ref.CHUNK, ref.R_FULL, ref.R_PARTIAL) == (
        jref.FR, jref.T, jref.RATE, jref.CHUNK, jref.R_FULL, jref.R_PARTIAL)
    assert ref.round_constants() == jref.round_constants()
    assert ref.mds_matrix() == jref.mds_matrix()
    rng = np.random.default_rng(5)
    for m in _messages() + [rng.bytes(int(n)) for n in rng.integers(0, 700, 12)]:
        assert ref.pad_input(m) == jref.pad_input(m)
        assert ref.absorb_elements(m) == jref.absorb_elements(m)
        assert ref.poseidon_hash(m) == jref.poseidon_hash(m), len(m)
    state = [int.from_bytes(rng.bytes(32), "big") % FR for _ in range(3)]
    assert ref.permutation(state) == jref.permutation(state)


def test_tables_match_the_jax_module():
    np.testing.assert_array_equal(poseidon._RC_MONT, np.asarray(jposeidon._RC_MONT, dtype=np.int64))
    np.testing.assert_array_equal(poseidon._MDS_MONT, np.asarray(jposeidon._MDS_MONT, dtype=np.int64))
    np.testing.assert_array_equal(poseidon._FULL_FLAG, np.asarray(jposeidon._FULL_FLAG, dtype=np.int64))
    # the kernel's table: the same constants as 32-bit words, in csrc/poseidon.cu's layout
    t = poseidon.KERNEL_TABLE.view(np.uint32)
    assert _ints(t[0:8]) == [FR] and _ints(t[8:16]) == [R * R % FR]
    assert int(t[16]) * FR % (1 << 32) == (1 << 32) - 1 and not t[17:24].any()
    mds = [v * R_INV % FR for v in _ints(t[24:96])]
    assert mds == [m for row in ref.mds_matrix() for m in row]
    rc_end = 96 + 65 * 24
    rc = [v * R_INV % FR for v in _ints(t[96:rc_end])]
    assert rc == [c for row in ref.round_constants() for c in row]
    assert t[rc_end : rc_end + 65].tolist() == jposeidon._FULL_FLAG.tolist()
    assert t.size == rc_end + 65 + 3 and not t[rc_end + 65 :].any()


def test_plain_matches_the_jax_oracle_and_padding():
    msgs = _messages()
    got = poseidon.poseidon_packed(*_packed(msgs))
    assert got.dtype == torch.uint8 and got.shape == (len(msgs), 32)
    assert [bytes(g) for g in got.numpy()] == [jref.poseidon_hash(m) for m in msgs]
    assert poseidon.poseidon_packed(*_packed([])).shape == (0, 32)
    # the padding and encoding: the JAX pad_poseidon's blocks, lane for lane
    elems, nblocks = poseidon.absorb_limbs(*_packed(msgs))
    bsz, m = elems.shape[:2]
    F = poseidon._consts(torch.device("cpu"))[0]
    mont = F.from_plain(elems.reshape(-1, 16).T).T.reshape(bsz, m, 2, 16)
    blocks, jnblocks = jposeidon.pad_poseidon(msgs)
    np.testing.assert_array_equal(nblocks.numpy(), jnblocks[:bsz])
    np.testing.assert_array_equal(mont.numpy(), blocks[:bsz, :m].astype(np.int64))
    assert not blocks[:bsz, m:].any()
    # the sponge over the JAX blocks, pad lanes and slots included
    words = poseidon.poseidon_blocks(torch.from_numpy(blocks.astype(np.int64)), torch.from_numpy(jnblocks))
    np.testing.assert_array_equal(poseidon.limbs_be_bytes(words)[:bsz].numpy(), got.numpy())


def test_plain_reads_any_layout():
    """Shuffled starts, starts off alignment and [B, 64] rows (the address
    form's input) give each message's own digest."""
    rng = np.random.default_rng(12)
    msgs = [rng.bytes(n) for n in (5, 62, 130, 31, 0, 64)]
    data, starts, lengths = hash_common.pack_messages(msgs)
    order = rng.permutation(len(msgs))
    shifted = np.concatenate([np.zeros(3, np.uint8), data])
    got = poseidon.poseidon_packed(
        torch.from_numpy(shifted), torch.from_numpy(starts[order] + 3), torch.from_numpy(lengths[order])
    )
    assert [bytes(g) for g in got.numpy()] == [ref.poseidon_hash(msgs[i]) for i in order]
    rows = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    got = poseidon.poseidon_packed(*hash_common.rows_as_packed(torch.from_numpy(rows)))
    assert [bytes(g) for g in got.numpy()] == [ref.poseidon_hash(bytes(r)) for r in rows]


@pytest.mark.parametrize("n", [1, 2, 16, 17, 33])
def test_merkle_root_matches_the_jax_walker(n):
    leaves = np.random.default_rng(n).integers(0, 256, (n, 32), dtype=np.uint8)
    want = _ref_tree_root([bytes(x) for x in leaves], "poseidon")
    assert merkle.merkle_root(leaves, hasher="poseidon", device="cpu") == want
    if n == 17:
        tree = merkle.MerkleTree(leaves, hasher="poseidon", device="cpu")
        assert tree.root == want
        proof = tree.proof(16)
        assert merkle.MerkleTree.verify_proof(bytes(leaves[16]), 16, n, proof, want, hasher="poseidon")
        assert not merkle.MerkleTree.verify_proof(bytes(leaves[15]), 16, n, proof, want, hasher="poseidon")


def test_suite_through_the_plane_matches_direct(monkeypatch):
    """Three ragged callers of Poseidon's hash_batch_async share one
    dispatch; each caller's digests equal its direct call's and the
    oracle's; addresses and a tree ride the plane too."""
    impl = suite.Poseidon(torch.device("cpu"))
    assert isinstance(impl, suite.Poseidon) and impl.device == torch.device("cpu")
    rng = np.random.default_rng(3)
    batches = [[rng.bytes(int(k)) for k in rng.integers(0, 130, n)] for n in (1, 3, 5)]
    plane = DevicePlane(window_ms=60_000, high_water=9, starvation_ms=60_000)
    monkeypatch.setattr(plane_mod, "_PLANE", plane)
    out: list = [None] * len(batches)
    barrier = threading.Barrier(len(batches))

    def call(i):
        barrier.wait()
        out[i] = impl.hash_batch_async(batches[i])()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert plane.stats()["dispatches"] == 1 and plane.stats()["merged_requests"] == 3
    monkeypatch.setenv("FISCO_DEVICE_PLANE", "0")
    for batch, digests in zip(batches, out):
        np.testing.assert_array_equal(digests, impl.hash_batch(batch))
        assert [bytes(d) for d in digests] == [ref.poseidon_hash(m) for m in batch]
    monkeypatch.delenv("FISCO_DEVICE_PLANE")
    assert impl.hash(b"abc") == jref.poseidon_hash(b"abc")
    monkeypatch.setattr(plane_mod, "_PLANE", DevicePlane(window_ms=0))
    keys = rng.integers(0, 256, (2, 64), dtype=np.uint8)
    assert [bytes(a) for a in impl.address_batch(keys)] == [ref.poseidon_hash(bytes(k))[12:] for k in keys]
    cpu_suite = suite.CryptoSuite(impl, suite.Secp256k1Crypto(torch.device("cpu")))
    leaves = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    assert cpu_suite.merkle_tree(leaves).root == _ref_tree_root([bytes(x) for x in leaves], "poseidon")
    assert plane_mod._PLANE.stats()["requests"] == 2


# -- the kernel's arithmetic, built as host C++ --------------------------------


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the Poseidon kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("poseidon_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(csrc=_kernels.CSRC))
    lib_path = d / "libposeidon_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_fr_op.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.host_permute.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.host_poseidon.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    for fn in (lib.host_fr_op, lib.host_permute, lib.host_poseidon):
        fn.restype = None
    lib.table = np.ascontiguousarray(poseidon.KERNEL_TABLE.view(np.uint32))
    return lib


def _edge_operands() -> tuple[list[int], list[int]]:
    """0, 1, FR - 1 and values near 2^254 (a product's first operand may be
    any value below 2^256: a·b < FR·R for b < FR), then seeded ones."""
    rng = np.random.default_rng(0xB254)
    rand = [int.from_bytes(rng.bytes(32), "big") % FR for _ in range(20)]
    near = [(1 << 254) - 1, (1 << 254) - FR // 3, (1 << 254) + 12345, R - 1, FR, FR + 1]
    a = [0, 1, FR - 1, FR - 1, 1, FR - 2] + near + rand
    b = [FR - 1, FR - 1, FR - 1, 1, 0, 2] + [FR - 1, 7, FR - 1, FR - 1, FR - 1, 1] + rand[::-1]
    return a, b


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_kernel_field_ops_match_python_integers(host, op):
    a, b = _edge_operands()
    if op == "sqr":
        a = [v for v in a if v < 1 << 255]  # a^2 < FR·R
    b = b[: len(a)]
    out = np.zeros((len(a), 8), np.uint32)
    aw, bw = _words(a), _words(b)
    host.host_fr_op(0 if op == "mul" else 1, aw.ctypes.data, bw.ctypes.data, host.table.ctypes.data,
                    out.ctypes.data, len(a))
    want = [x * y * R_INV % FR for x, y in zip(a, b)] if op == "mul" else [x * x * R_INV % FR for x in a]
    assert _ints(out) == want


def test_kernel_mds_row_and_permutation_match_the_oracle(host):
    rng = np.random.default_rng(0x3D5)
    states = [[int.from_bytes(rng.bytes(32), "big") % FR for _ in range(3)] for _ in range(6)]
    states += [[0, 0, 0], [FR - 1, FR - 1, FR - 1], [1, 0, FR - 1]]
    mont = [[v * R % FR for v in s] for s in states]
    # an MDS row: the sum of three products, one reduction
    rows = [[int.from_bytes(rng.bytes(32), "big") % FR for _ in range(3)] for _ in states]
    sw, rw = _words([v for s in mont for v in s]), _words([v for r in rows for v in r])
    out = np.zeros((len(states), 8), np.uint32)
    host.host_fr_op(2, sw.ctypes.data, rw.ctypes.data, host.table.ctypes.data, out.ctypes.data, len(states))
    assert _ints(out) == [sum(x * y for x, y in zip(s, r)) * R_INV % FR for s, r in zip(mont, rows)]
    # the permutation, in the Montgomery domain in place
    host.host_permute(sw.ctypes.data, host.table.ctypes.data, len(states))
    got = [v * R_INV % FR for v in _ints(sw)]
    assert got == [v for s in states for v in ref.permutation(s)]


@pytest.mark.parametrize("layout", ["packed", "offsets", "merkle level"])
def test_kernel_sponge_matches_the_oracle(host, layout):
    """The kernel's message function: padding, chunking, encoding, sponge
    and squeeze, on the edge sweep, its messages at every offset in
    shuffled order, and a merkle level's groups of 16 nodes (the last one
    short)."""
    rng = np.random.default_rng(9)
    msgs = _messages() + [rng.bytes(int(n)) for n in rng.integers(0, 701, 14)]
    if layout == "merkle level":
        data = rng.integers(0, 256, 37 * 32, dtype=np.uint8)
        first = np.arange(0, 37, 16)
        starts, lengths = first * 32, np.minimum(16, 37 - first) * 32
    else:
        gaps = rng.integers(0, 16, len(msgs)) if layout == "offsets" else np.zeros(len(msgs), int)
        data = np.frombuffer(b"".join(bytes(int(g)) + m for g, m in zip(gaps, msgs)), dtype=np.uint8)
        starts = np.cumsum([int(g) + len(m) for g, m in zip(gaps, msgs)]) - [len(m) for m in msgs]
        lengths = np.array([len(m) for m in msgs])
        order = rng.permutation(len(msgs)) if layout == "offsets" else np.arange(len(msgs))
        starts, lengths = starts[order], lengths[order]
    data = np.ascontiguousarray(data, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    out = np.zeros((len(starts), 32), np.uint8)
    host.host_poseidon(data.ctypes.data, starts.ctypes.data, lengths.ctypes.data, host.table.ctypes.data,
                       out.ctypes.data, len(starts))
    assert [bytes(o) for o in out] == [ref.poseidon_hash(data[s : s + n].tobytes()) for s, n in zip(starts, lengths)]


def test_kernel_source_design():
    """The instance's shape in the source equals the oracle's; no constant
    of the instance is written there (they reach the kernel in the table);
    the table's length equals the layout's; the launch returns its CUDA
    error, exports its geometry and refuses a table of another length."""
    src = _kernels.SOURCES["poseidon"].read_text()
    shape = dict(re.findall(r"#define POSEIDON_(T|RATE|ROUNDS|CHUNK) (\d+)", src))
    assert shape == {"T": str(ref.T), "RATE": str(ref.RATE), "ROUNDS": str(ref.N_ROUNDS), "CHUNK": str(ref.CHUNK)}
    words = {f"{int(w):08x}" for w in poseidon.KERNEL_TABLE.view(np.uint32) if w > 0xFFFF}
    assert not [w for w in words if re.search(w, src, re.IGNORECASE)]
    for needle in ("cudaGetLastError", "poseidon_geometry", "table_words != PT_WORDS", "#pragma unroll 1"):
        assert needle in src


def test_host_table_length_is_the_layouts(host):
    host.host_table_words.restype = ctypes.c_int
    assert host.host_table_words() == poseidon.KERNEL_TABLE.size
