"""Poseidon in the port on the CPU: the port's oracle against the JAX
package's on every 31/62-byte edge; the derived tables against the JAX
module's ``_RC_MONT``, ``_MDS_MONT`` and ``_FULL_FLAG``; the plain packed
version (``ops/poseidon.py``) against the JAX oracle and its padding against
the JAX ``pad_poseidon``; merkle roots with hasher ``"poseidon"`` against the
JAX state plane's independent walker; the ``Poseidon`` HashImpl through the
DevicePlane against its direct call; the sparse partial-round form the
kernel runs (``ops/poseidon.py``), from its table, against the oracle's
permutation; and the kernel's arithmetic (``csrc/poseidon.cu``) built with
g++, a lane group's four lanes run one after another: its Montgomery
product, squaring, MDS row, permutation and sponge against Python integers
and the oracle, the rows of its lane programs walked for hazards, its
launch geometry. No JAX program is traced (the JAX sponge's XLA-CPU compile
takes minutes); the kernel itself runs only on the card, through
chip_smoke.py."""

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
  for (int i = 0; i < n; i++) poseidon_permute(s + 24 * i, table);
}}

// message i of the packed batch -> out[32 i ..], the digest as the kernel
// stores it; with `warp`, every message runs the blocks of the batch's
// longest, as the lane groups of one warp do
extern "C" void host_poseidon(const uint8_t* data, const int64_t* starts, const int32_t* lengths,
                              const u32* table, uint8_t* out, int n, int warp) {{
  int wblocks = 0;
  for (int i = 0; i < n; i++) {{
    const int nb = (int)(lengths[i] / POSEIDON_BLOCK_BYTES + 1);
    wblocks = nb > wblocks ? nb : wblocks;
  }}
  for (int i = 0; i < n; i++) {{
    u32 d[8];
    if (warp) {{
      u32 sl[PS_SLOT_WORDS], x[8];
      ps_message(data + starts[i], lengths[i], (int)(lengths[i] / POSEIDON_BLOCK_BYTES + 1), wblocks, sl, 1,
                 table, x);
      ps_digest(d, x, table);
    }} else {{
      poseidon_message(data + starts[i], lengths[i], table, d);
    }}
    for (int j = 0; j < 32; j++) out[32 * i + j] = (uint8_t)(d[j >> 2] >> (8 * (j & 3)));
  }}
}}

extern "C" int host_table_words() {{ return PT_WORDS; }}

// Every row of every lane program: each op's operands in range, one kind
// a row, and no op writing a slot that another lane's op of the row reads
// or writes (so the lanes may run a row in any order). Returns the
// offences; *rows gets the rows walked.
extern "C" int host_row_hazards(int* rows) {{
  int bad = 0;
  for (int r = 0; r < PS_PROG_ROWS; r++) {{
    *rows = r + 1;
    bool rd[POSEIDON_GROUP][64] = {{}}, wr[POSEIDON_GROUP][64] = {{}};
    for (int j = 0; j < POSEIDON_GROUP; j++) {{
      const u64 op = PS_PROGS[r][j];
      const u32 kind = (u32)(op >> 62), d = (u32)op & 63;
      bad += kind != (u32)(PS_PROGS[r][0] >> 62);
      bad += d >= PS_SLOTS;
      wr[j][d] = true;
      // fields 1..8: a0, b0, a1, b1, a2, b2, c, e; a squaring reads a0 alone
      for (int k = 1; k <= 8; k++) {{
        const u32 c = (u32)(op >> (6 * k)) & 63;
        const bool used = kind == PS_SQR ? k == 1 : k >= 7 || k <= 2 * (int)kind;
        if (!used) continue;
        bad += (c >= PS_SLOTS && c < PS_K0) || (c > PS_M22 && c < PS_ZERO) || c > PS_ST2;
        if (c < PS_SLOTS) rd[j][c] = true;
      }}
    }}
    for (int j = 0; j < POSEIDON_GROUP; j++)
      for (int k = 0; k < POSEIDON_GROUP; k++)
        for (int s = 0; s < PS_SLOTS; s++)
          if (k != j && wr[j][s] && (rd[k][s] || wr[k][s])) bad++;
  }}
  return bad;
}}

extern "C" int host_slots() {{ return PS_SLOTS; }}
extern "C" int host_prog_rows() {{ return PS_PROG_ROWS; }}
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
    # the kernel's table, in csrc/poseidon.cu's layout: FR, n0, zero, R^2,
    # then the sparse form's constants (test_sparse_form_from_the_table_...)
    t = poseidon.KERNEL_TABLE.view(np.uint32)
    assert _ints(t[0:8]) == [FR] and _ints(t[24:32]) == [R * R % FR]
    assert int(t[8]) * FR % (1 << 32) == (1 << 32) - 1 and not t[9:24].any()
    start = [v * R_INV % FR for v in _ints(t[32:56])]
    assert start == [c for c in ref.round_constants()[0]]  # round 0's constants stay where they were
    full = 56 + 65 * 96
    rounds = [v * R_INV % FR for v in _ints(t[56:full])]
    # the full rounds' mixes are the MDS but the last of the first half's (the moved factor's)
    mds = [m for row in ref.mds_matrix() for m in row]
    assert [r for r in range(65) if rounds[12 * r + 3 : 12 * r + 12] == mds] == [0, 1, 2, 61, 62, 63, 64]
    # the full rounds' end constants are the next round's (none after the last)
    for r in (0, 1, 2, 61, 62, 63):
        assert rounds[12 * r : 12 * r + 3] == list(ref.round_constants()[r + 1])
    assert rounds[12 * 64 : 12 * 64 + 3] == [0, 0, 0]
    assert t[full : full + 65].tolist() == jposeidon._FULL_FLAG.tolist()
    assert t.size == full + 65 + 3 and not t[full + 65 :].any()


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
    lib.host_poseidon.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int]
    lib.poseidon_geometry.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.host_row_hazards.argtypes = [ctypes.c_void_p]
    for fn in (lib.host_fr_op, lib.host_permute, lib.host_poseidon, lib.poseidon_geometry):
        fn.restype = None
    for fn in (lib.host_row_hazards, lib.host_prog_rows, lib.host_table_words, lib.host_slots):
        fn.restype = ctypes.c_int
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
                       out.ctypes.data, len(starts), 0)
    assert [bytes(o) for o in out] == [ref.poseidon_hash(data[s : s + n].tobytes()) for s, n in zip(starts, lengths)]


def test_kernel_sponge_in_a_warp_keeps_each_digest(host):
    """Lane groups of one warp run the blocks of its longest message: a
    message of fewer blocks absorbs zeros after its own and keeps the
    digest of its last block (lengths 0 to 700 bytes, 1 to 12 blocks)."""
    rng = np.random.default_rng(21)
    msgs = [rng.bytes(int(n)) for n in (0, 61, 62, 700, 123, 5, 640, 186)]
    data, starts, lengths = (np.ascontiguousarray(a) for a in hash_common.pack_messages(msgs))
    out = np.zeros((len(msgs), 32), np.uint8)
    host.host_poseidon(data.ctypes.data, starts.ctypes.data, lengths.ctypes.data, host.table.ctypes.data,
                       out.ctypes.data, len(msgs), 1)
    assert [bytes(o) for o in out] == [ref.poseidon_hash(m) for m in msgs]


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
    for needle in ("cudaGetLastError", "poseidon_geometry", "table_words != PT_WORDS", "#pragma unroll 1",
                   "__reduce_max_sync", "__syncwarp", "PS_LANE_FOR", "__launch_bounds__"):
        assert needle in src


def test_host_table_length_is_the_layouts(host):
    assert host.host_table_words() == poseidon.KERNEL_TABLE.size == poseidon.TABLE_WORDS


def test_lane_rows_have_no_hazards(host):
    """No row of any lane program mixes kinds of op, reads an operand out of
    range, or writes a slot that another lane's op of the row reads or
    writes, so a group's lanes may run a row in any order (as the host
    build runs them, one after another)."""
    rows = ctypes.c_int(0)
    assert host.host_row_hazards(ctypes.byref(rows)) == 0
    assert rows.value == host.host_prog_rows() == 13  # absorb 1, start 1, two full rounds 8, partial 3


@pytest.mark.parametrize("n", [1, 5, 68, 1088, 10240, 40960])
def test_geometry_fills_the_card(host, n):
    """Four lanes a message, 8 messages a warp: every message gets a lane
    group; a page tree's 1,088-message level spreads over at least 100 of
    the 132 SMs (one warp a block); a 10,240-message launch holds at least
    two warps for each of the 528 schedulers; blocks hold at most 4 warps."""
    out = (ctypes.c_int * 3)()
    host.poseidon_geometry(n, out)
    threads, blocks, smem = out
    assert threads % 32 == 0 and 32 <= threads <= 128 and blocks * threads >= 4 * n
    assert blocks * threads < 4 * n + threads  # no block without a message
    assert smem == threads // 32 * 8 * host.host_slots() * 32  # a message's slots, 32 bytes each
    if n == 1088:
        assert blocks >= 100
    if n >= 10240:
        assert blocks * threads // 32 >= 2 * 132 * 4


def _table_values(t: np.ndarray, at: int, count: int) -> list[int]:
    """`count` 8-word values of the kernel table from word `at`, out of the
    Montgomery domain."""
    return [v * R_INV % FR for v in _ints(t[at : at + 8 * count])]


def test_sparse_form_from_the_table_matches_the_oracle():
    """The kernel's constants, read back from its table and applied in
    Python integers as its rows apply them (start constants, then each
    round's S-boxes, mix and end constants), give ref.permutation on seeded
    states and on [0, 0, 0], [FR-1]*3 and [1, 0, FR-1]; every partial
    round's mix is sparse; ops/poseidon.py's own sparse_permutation agrees."""
    t = poseidon.KERNEL_TABLE.view(np.uint32)
    lay = poseidon.TABLE_LAYOUT
    start = _table_values(t, lay["start"], 3)
    blocks = [_table_values(t, lay["rounds"] + 96 * r, 12) for r in range(65)]
    full = t[lay["full"] : lay["full"] + 65].tolist()
    assert full == jposeidon._FULL_FLAG.tolist()
    for r in range(65):
        if not full[r]:
            assert blocks[r][3 + 4 : 3 + 6] == [1, 0] and blocks[r][3 + 7 : 3 + 9] == [0, 1]

    def permute(s):
        s = [(x + c) % FR for x, c in zip(s, start)]
        for r in range(65):
            end, mix = blocks[r][:3], blocks[r][3:]
            s = [pow(x, 5, FR) for x in s] if full[r] else [pow(s[0], 5, FR)] + s[1:]
            s = [(sum(mix[3 * i + j] * s[j] for j in range(3)) + end[i]) % FR for i in range(3)]
        return s

    rng = np.random.default_rng(0x5A)
    states = [[int.from_bytes(rng.bytes(32), "big") % FR for _ in range(3)] for _ in range(6)]
    states += [[0, 0, 0], [FR - 1] * 3, [1, 0, FR - 1]]
    for s in states:
        want = ref.permutation(s)
        assert permute(s) == want and poseidon.sparse_permutation(s) == want
