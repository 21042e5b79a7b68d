"""The hash kernels' arithmetic (csrc/keccak256.cuh, csrc/sm3.cuh), built as
host C++, against the port's reference hashes and the plain packed
versions, over a sweep of lengths around every padding edge, the row forms
the admission path hashes and a merkle level's layout; and the packed
layout itself (pack_messages, rows_as_packed) against the JAX padding's
blocks-form functions. The kernels themselves run only on the card, through
chip_smoke.py."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256 as ref_keccak256
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3 as ref_sm3
from fisco_bcos_tpu_torch.ops import _kernels, hash_common, keccak, sm3

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

    def run(which: int, data: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        out = np.zeros((len(starts), 32), dtype=np.uint8)
        lib.host_packed_hash(which, data.ctypes.data, starts.ctypes.data, lengths.ctypes.data,
                             out.ctypes.data, len(starts))
        return out

    return run


def _sweep():
    """The edge lengths, then seeded lengths of 0-700 bytes."""
    rng = np.random.default_rng(23)
    lengths = EDGE_LENGTHS + rng.integers(0, 701, 48).tolist()
    return [rng.bytes(int(n)) for n in lengths]


def _held(name, host_hash, data, starts, lengths, messages):
    """The host-built kernel == the plain packed version == the reference,
    on every message."""
    which, ref, plain = HASHERS[name]
    got = host_hash(which, data, starts, lengths)
    want = plain(*(torch.from_numpy(np.array(a)) for a in (data, starts, lengths))).numpy()
    np.testing.assert_array_equal(got, want)
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
