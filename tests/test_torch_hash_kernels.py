"""The hash kernels' arithmetic (csrc/keccak256.cuh, csrc/sm3.cuh,
csrc/hash_kernel.cuh), built as host C++, against the port's reference
hashes and the plain versions: messages read where they lie and through the
staged word reader, over a sweep of lengths around every padding edge, the
row forms the admission path hashes and a merkle level's layout; the forms'
lanes (limb rows to message bytes, the tx hash's limbs, the sender from
limbs, SM2's e continued from a per-ID midstate); and the packed layout
itself (pack_messages, rows_as_packed) against the JAX padding's
blocks-form functions. The kernels themselves run only on the card, through
chip_smoke.py."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref_ecdsa
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256 as ref_keccak256
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3 as ref_sm3
from fisco_bcos_tpu_torch.ops import _kernels, address, bigint, hash_common, keccak, sm2, sm3

# keccak: 135/136/137 and 271/272 cross a 136-byte rate block; SM3: 55/56
# spill the length field, 63/64/119/120 cross 64-byte blocks
EDGE_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 135, 136, 137, 271, 272, 512]
HASHERS = {
    "keccak256": (0, ref_keccak256, keccak.keccak256_packed_plain),
    "sm3": (1, ref_sm3, sm3.sm3_packed_plain),
}

SHIM = r"""
#include "{csrc}/keccak256.cu"
#include "{csrc}/sm3.cu"

// message i of the packed batch -> out[32 i ..]; which: 0 keccak-256, 1 SM3
extern "C" void host_packed_hash(int which, const uint8_t* data, const int64_t* starts,
                                 const int32_t* lengths, uint8_t* out, int n) {{
  for (int i = 0; i < n; i++) {{
    if (which == 0) keccak256_message(data + starts[i], lengths[i], out + 32 * i);
    else sm3_message(data + starts[i], lengths[i], out + 32 * i);
  }}
}}

static void put_words(const uint32_t* w, int n, uint8_t* out) {{
  for (int j = 0; j < 4 * n; j++) out[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
}}

// the same through the staged route's reader: message i at byte starts[i]
// of the 4-byte aligned words
extern "C" void host_word_hash(int which, const uint32_t* words, const int64_t* starts,
                               const int32_t* lengths, uint8_t* out, int n) {{
  for (int i = 0; i < n; i++) {{
    const WordReader r{{words, (uint32_t)starts[i]}};
    uint32_t d[8];
    if (which == 0) Keccak256::message(r, lengths[i], d);
    else Sm3::message(r, lengths[i], d);
    put_words(d, 8, out + 32 * i);
  }}
}}

// [n, 16] limb rows -> their [n, 32] big-endian bytes, as the forms read them
extern "C" void host_limbs_to_bytes(const int32_t* limbs, uint8_t* out, int n) {{
  for (int i = 0; i < n; i++) {{
    uint32_t be[8], mem[8];
    limbs_to_be_words(limbs + 16 * i, be);
    for (int j = 0; j < 8; j++) mem[j] = bswap32(be[j]);
    put_words(mem, 8, out + 32 * i);
  }}
}}

// the tx-hash form's limbs of [n, 32] digests
extern "C" void host_digest_limbs(const uint8_t* digests, int32_t* limbs, int n) {{
  for (int i = 0; i < n; i++) {{
    uint32_t d[8], z[16];
    for (int j = 0; j < 8; j++) d[j] = load_bytes<uint32_t, 4, false>(digests + 32 * i + 4 * j, 4);
    digest_limbs(d, z);
    for (int j = 0; j < 16; j++) limbs[16 * i + j] = (int32_t)z[j];
  }}
}}

// the sender form's lanes: ok may be null
extern "C" void host_sender(int which, const int32_t* qx, const int32_t* qy, const uint8_t* ok,
                            uint8_t* addr, uint8_t* pub, int n) {{
  for (int i = 0; i < n; i++) {{
    uint32_t key[16] = {{0}}, bytes[16], a[5];
    if (ok == nullptr || ok[i]) {{
      limbs_to_be_words(qx + 16 * i, key);
      limbs_to_be_words(qy + 16 * i, key + 8);
    }}
    if (which == 0) sender_lane<Keccak256>(key, bytes, a);
    else sender_lane<Sm3>(key, bytes, a);
    put_words(bytes, 16, pub + 64 * i);
    put_words(a, 5, addr + 20 * i);
  }}
}}

// the e form's lanes: za the ID's [32] midstate, h [n, 32] digests
extern "C" void host_sm3_e(const uint32_t* za, const uint8_t* h, const int32_t* qx,
                           const int32_t* qy, int32_t* e_limbs, int n) {{
  for (int i = 0; i < n; i++) {{
    uint32_t key[16], hw[8], e[8], limbs[16], row[SM3_E_ROW_WORDS] = {{0}};
    limbs_to_be_words(qx + 16 * i, key);
    limbs_to_be_words(qy + 16 * i, key + 8);
    for (int j = 0; j < 8; j++) hw[j] = load_bytes<uint32_t, 4, true>(h + 32 * i + 4 * j, 4);
    sm3_e_lane(za, row, key, hw, e);
    be_words_to_limbs(e, limbs);
    for (int j = 0; j < 16; j++) e_limbs[16 * i + j] = (int32_t)limbs[j];
  }}
}}
"""


@pytest.fixture(scope="module")
def host_hash(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the hash kernels' arithmetic for the host")
    d = tmp_path_factory.mktemp("hash_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(csrc=_kernels.CSRC))
    lib_path = d / "libhash_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_packed_hash.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.host_packed_hash.restype = None
    lib.host_word_hash.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.host_word_hash.restype = None

    def run(which: int, data: np.ndarray, starts: np.ndarray, lengths: np.ndarray, words=False) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if words:  # 4-byte aligned, with the 12 bytes the reader may load past the end
            data = np.concatenate([data, np.zeros(16 - data.size % 4, dtype=np.uint8)]).view(np.uint32)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        out = np.zeros((len(starts), 32), dtype=np.uint8)
        fn = lib.host_word_hash if words else lib.host_packed_hash
        fn(which, data.ctypes.data, starts.ctypes.data, lengths.ctypes.data, out.ctypes.data, len(starts))
        return out

    run.lib = lib
    return run


def _sweep():
    """The edge lengths, then seeded lengths of 0-700 bytes."""
    rng = np.random.default_rng(23)
    lengths = EDGE_LENGTHS + rng.integers(0, 701, 48).tolist()
    return [rng.bytes(int(n)) for n in lengths]


def _held(name, host_hash, data, starts, lengths, messages):
    """The host-built kernel, through both readers (the direct route's and
    the staged route's), == the plain packed version == the reference, on
    every message."""
    which, ref, plain = HASHERS[name]
    got = host_hash(which, data, starts, lengths)
    want = plain(*(torch.from_numpy(np.array(a)) for a in (data, starts, lengths))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host_hash(which, data, starts, lengths, words=True), want)
    for i, m in enumerate(messages):
        assert bytes(got[i]) == ref(m), (name, len(m))


@pytest.mark.parametrize("name", HASHERS)
def test_length_sweep(name, host_hash):
    msgs = _sweep()
    _held(name, host_hash, *hash_common.pack_messages(msgs), msgs)


@pytest.mark.parametrize("name", HASHERS)
@pytest.mark.parametrize("width", [64, 210])
def test_row_forms(name, width, host_hash):
    """[B, 64] pubkey rows (the sender) and [B, 210] ZA rows (SM2's e)."""
    rows = np.random.default_rng(width).integers(0, 256, (37, width), dtype=np.uint8)
    data, starts, lengths = hash_common.rows_as_packed(torch.from_numpy(rows))
    _held(name, host_hash, data.numpy(), starts.numpy(), lengths.numpy(), [bytes(r) for r in rows])


@pytest.mark.parametrize("name", HASHERS)
def test_merkle_level_layout(name, host_hash):
    """One level over 37 nodes at width 16: groups start 512 bytes apart,
    and the short last group keeps its true length."""
    nodes = np.random.default_rng(37).integers(0, 256, (37, 32), dtype=np.uint8)
    first = np.arange(0, 37, 16)
    starts = first * 32
    lengths = np.minimum(16, 37 - first) * 32
    assert lengths.tolist() == [512, 512, 160]
    groups = [nodes[g : g + 16].tobytes() for g in first]
    _held(name, host_hash, nodes.reshape(-1), starts, lengths, groups)


@pytest.mark.parametrize("name", HASHERS)
def test_word_reader_any_offset(name, host_hash):
    """The staged route's reader at every offset mod 16 and in shuffled
    order: the sweep's messages with a gap of 0-15 bytes before each, read
    in a shuffled order."""
    msgs = _sweep()
    rng = np.random.default_rng(5)
    gaps = rng.integers(0, 16, len(msgs))
    data = b"".join(bytes(int(g)) + m for g, m in zip(gaps, msgs))
    ends = np.cumsum([int(g) + len(m) for g, m in zip(gaps, msgs)])
    starts = ends - [len(m) for m in msgs]
    assert len({int(s) % 16 for s in starts}) == 16
    order = rng.permutation(len(msgs))
    data = np.frombuffer(data, dtype=np.uint8)
    lengths = np.array([len(m) for m in msgs])[order]
    _held(name, host_hash, data, starts[order], lengths, [msgs[i] for i in order])


def _limb_rows(rng, n):
    """[n, 16] int32 limbs of seeded 256-bit values, the zero key and
    2^256 - 1 among them."""
    limbs = rng.integers(0, 1 << 16, (n, 16)).astype(np.int32)
    limbs[0] = 0
    limbs[1] = 0xFFFF
    return limbs


def test_limb_rows_to_message_bytes(host_hash):
    """limbs_to_be_words, as the sender and e forms read the EC kernels'
    limbs, == limbs_to_bytes_device; and the tx-hash form's digest limbs ==
    bytes_be_to_limbs_device."""
    lib = host_hash.lib
    lib.host_limbs_to_bytes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.host_digest_limbs.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    limbs = _limb_rows(np.random.default_rng(16), 64)
    got = np.zeros((64, 32), dtype=np.uint8)
    lib.host_limbs_to_bytes(limbs.ctypes.data, got.ctypes.data, 64)
    want = bigint.limbs_to_bytes_device(torch.from_numpy(limbs)).to(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    z = np.zeros((64, 16), dtype=np.int32)
    lib.host_digest_limbs(got.ctypes.data, z.ctypes.data, 64)
    np.testing.assert_array_equal(z, limbs)
    np.testing.assert_array_equal(z, bigint.bytes_be_to_limbs_device(torch.from_numpy(got)).numpy())


@pytest.mark.parametrize("name", HASHERS)
def test_sender_lanes(name, host_hash):
    """The sender form's lanes from limbs == the plain sender == the
    reference: right160(H(x ‖ y)) and the key's bytes, the zero key and,
    given ok, the zeroed not-ok lanes included."""
    lib = host_hash.lib
    lib.host_sender.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
    which, ref, _ = HASHERS[name]
    rng = np.random.default_rng(64 + which)
    qx, qy = _limb_rows(rng, 48), _limb_rows(rng, 48)
    ok = rng.integers(0, 2, 48).astype(bool)
    plain = {"keccak256": address.sender_address_plain, "sm3": address.sm3_sender_address_plain}[name]
    for mask in (None, ok) if name == "keccak256" else (ok,):
        addr = np.zeros((48, 20), dtype=np.uint8)
        pub = np.zeros((48, 64), dtype=np.uint8)
        lib.host_sender(which, qx.ctypes.data, qy.ctypes.data, None if mask is None else mask.ctypes.data,
                        addr.ctypes.data, pub.ctypes.data, 48)
        args = [torch.from_numpy(qx), torch.from_numpy(qy)]
        if mask is not None:
            args.append(torch.from_numpy(mask))
        want_addr, want_pub = (t.numpy() for t in plain(*args))
        np.testing.assert_array_equal(addr, want_addr)
        np.testing.assert_array_equal(pub, want_pub)
        for i in range(48):
            assert bytes(addr[i]) == ref(bytes(pub[i]))[12:]
            keep = mask is None or mask[i]
            assert bytes(pub[i]) == (bigint.limbs_to_bytes_be(qx[i]).tobytes() + bigint.limbs_to_bytes_be(qy[i]).tobytes()
                                     if keep else bytes(64))


# ENTL is 16 bits, so an ID runs to 8,191 bytes; the prefix's tail t =
# (len + 2) mod 64 is 0 at 62 and 63 at 61, and ZA's rest spills into a
# third block from t = 56 (54 bytes) on
ID_LENGTHS = [0, 1, 16, 53, 54, 61, 62, 300, 8191]


@pytest.mark.parametrize("id_len", ID_LENGTHS)
def test_sm3_e_lane_from_midstate(id_len, host_hash):
    """SM3 continued from sm2.za_midstate with ZA's whole length in the
    padding: the e form's lanes == the plain e (both passes whole) == the
    reference sm2_e_bytes."""
    lib = host_hash.lib
    lib.host_sm3_e.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    user_id = bytes(np.random.default_rng(id_len).integers(0, 256, id_len, dtype=np.uint8))
    rng = np.random.default_rng(1000 + id_len)
    qx, qy = _limb_rows(rng, 12), _limb_rows(rng, 12)
    h = rng.integers(0, 256, (12, 32), dtype=np.uint8)
    za = sm2.za_midstate(user_id)
    assert za[8] == (id_len + 2) % 64 and za[9] == id_len + 2 + 128 + 64
    e = np.zeros((12, 16), dtype=np.int32)
    lib.host_sm3_e(za.ctypes.data, h.ctypes.data, qx.ctypes.data, qy.ctypes.data, e.ctypes.data, 12)
    plain = sm2.e_plain(*(torch.from_numpy(a) for a in (h, qx, qy)), user_id=user_id).numpy()
    np.testing.assert_array_equal(e, plain)
    e_bytes = bigint.limbs_to_bytes_be(e)
    for i in range(12):
        pub = bigint.limbs_to_bytes_be(qx[i]).tobytes() + bigint.limbs_to_bytes_be(qy[i]).tobytes()
        assert e_bytes[i].tobytes() == ref_ecdsa.sm2_e_bytes(pub, h[i].tobytes(), user_id), i


def test_pack_messages_layout():
    msgs = [b"ab", b"", bytes(range(7)), b"\xff" * 3]
    data, starts, lengths = hash_common.pack_messages(msgs)
    assert data.dtype == np.uint8 and starts.dtype == np.int64 and lengths.dtype == np.int32
    assert [bytes(data[s : s + n]) for s, n in zip(starts, lengths)] == msgs
    assert data.tobytes() == b"".join(msgs)
    for part in ([], [b""]):
        d, s, n = hash_common.pack_messages(part)
        assert d.size == 0 and s.tolist() == [0] * len(part) and n.tolist() == [0] * len(part)
    rows = np.arange(12, dtype=np.uint8).reshape(3, 4)
    packed = hash_common.pack_messages(list(rows))  # any bytes-like message
    np.testing.assert_array_equal(packed[0], rows.reshape(-1))
    np.testing.assert_array_equal(packed[1], [0, 4, 8])


def test_packed_plain_equals_blocks_form():
    """The plain packed versions pad as the JAX padding does: equal to the
    blocks-form functions (held against JAX in test_torch_keccak.py and
    test_torch_sm3.py) over pad_keccak and pad_md64."""
    msgs = _sweep()
    packed = [torch.from_numpy(np.array(a)) for a in hash_common.pack_messages(msgs)]
    blocks, nblocks = hash_common.pad_keccak(msgs)
    words = keccak.keccak256_blocks(torch.from_numpy(blocks.astype(np.int64)), torch.from_numpy(nblocks))
    want = hash_common.digest_words_to_bytes_le(words.numpy().astype(np.uint32))[: len(msgs)]
    np.testing.assert_array_equal(keccak.keccak256_packed_plain(*packed).numpy(), want)
    blocks, nblocks = hash_common.pad_md64(msgs)
    words = sm3.sm3_blocks(torch.from_numpy(blocks.astype(np.int64)), torch.from_numpy(nblocks))
    want = hash_common.digest_words_to_bytes_be(words.numpy().astype(np.uint32))[: len(msgs)]
    np.testing.assert_array_equal(sm3.sm3_packed_plain(*packed).numpy(), want)


@pytest.mark.parametrize("name", HASHERS)
def test_batch_entry_on_cpu(name):
    """keccak256_batch / sm3_batch with device="cpu": the plain path, never
    the kernel loader; an empty batch gives [0, 32]."""
    batch = {"keccak256": keccak.keccak256_batch, "sm3": sm3.sm3_batch}[name]
    msgs = _sweep()[:20]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda n: pytest.fail("kernel loader called on CPU"))
        got = batch(msgs, device="cpu")
        empty = batch([], device="cpu")
    assert got.dtype == np.uint8 and got.shape == (20, 32) and empty.shape == (0, 32)
    assert [bytes(g) for g in got] == [HASHERS[name][1](m) for m in msgs]


@pytest.mark.parametrize("name", HASHERS)
def test_kernel_source_design_and_constants(name):
    """One warp a block, the launch's CUDA error returned, the geometry
    exported, and the constants (keccak's round constants, SM3's IV) equal
    to the plain versions' copies."""
    src = _kernels.SOURCES[name].read_text()
    common = (_kernels.CSRC / "hash_kernel.cuh").read_text()
    header = (_kernels.CSRC / f"{name}.cuh").read_text()
    assert re.search(r"#define\s+HASH_THREADS\s+32\b", common)
    assert "__launch_bounds__(HASH_THREADS)" in common
    assert "return (int)cudaGetLastError();" in common
    assert f'extern "C" int {name}_launch(' in src and f'extern "C" void {name}_geometry(' in src
    table = {"keccak256": ("KECCAK_RC", keccak._RC), "sm3": ("SM3_IV", sm3._IV)}[name]
    body = re.search(r"%s\[\d+\] = \{([^}]*)\}" % table[0], header).group(1)
    assert [int(w.strip().rstrip("ul"), 16) for w in body.split(",") if w.strip()] == table[1]
