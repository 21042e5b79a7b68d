"""The port's multi-device fan-out (``fisco_bcos_tpu_torch/parallel``) on
CPU meshes, which name the one CPU device several times (the JAX tests' 8
host devices of tests/conftest.py, in the port's form): the split and the
gather, the mesh, the hash-only programs against the JAX programs at
D = 8, the packed split against the one-device keccak, the admission
programs and Ed25519's at D = 2 against the port's one-device calls, and
the DevicePlane's sharded admission under its ``admission_sharded`` span.
The secp256k1 and SM2 programs are in test_torch_sharding_ec.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.parallel import sharding as jsharding
from fisco_bcos_tpu_torch.crypto import admission
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.device.plane import DevicePlane
from fisco_bcos_tpu_torch.observability import device as dev_obs
from fisco_bcos_tpu_torch.ops import _kernels, ed25519, keccak, merkle
from fisco_bcos_tpu_torch.parallel import sharding
from fisco_bcos_tpu_torch.parallel.sharding import Mesh

from test_torch_admission import _signed
from test_torch_ed25519 import _columns, _lanes

CPU = torch.device("cpu")
SEED = 20_261_018


def cpu_mesh(d: int) -> Mesh:
    return Mesh((CPU,) * d)


@pytest.fixture(autouse=True)
def cpu_only(monkeypatch):
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))


# -- the mesh and the fan-out ---------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_fan_out_splits_and_gathers_in_order(d):
    rows = np.arange(32 * 3, dtype=np.int64).reshape(32, 3)
    flags = (np.arange(32) % 3 == 0).astype(np.int32)
    seen = []

    def body(t, f):
        seen.append(t.clone())
        return t + 1, f.sum(dtype=torch.int32)

    mesh = cpu_mesh(d)
    outs = sharding._fan_out(mesh, sharding._row_shards(mesh, rows, flags), body)
    assert [s.tolist() for s in seen] == [b.tolist() for b in np.split(rows, d)]
    np.testing.assert_array_equal(sharding._tiled(outs, 0).numpy(), rows + 1)
    total = sharding._psum(outs, 1)
    assert total.dtype == torch.int32 and total.shape == () and int(total) == flags.sum()


def test_a_batch_that_does_not_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        sharding._row_shards(cpu_mesh(4), np.zeros((6, 160), np.uint8))
    with pytest.raises(ValueError, match="does not split"):
        sharding.sharded_verify(cpu_mesh(4))(np.zeros((6, 160), np.uint8))
    with pytest.raises(ValueError, match="does not split"):
        sharding.sharded_merkle_root(cpu_mesh(4))(np.zeros((10, 32), np.uint8))
    with pytest.raises(ValueError, match="one row count"):
        sharding.sharded_qc_check(cpu_mesh(2))(np.zeros((4, 160), np.uint8), np.zeros(2, np.int32))


def test_mesh_of_one_device_type():
    with pytest.raises(ValueError, match="one type"):
        Mesh((CPU, torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="at least one"):
        Mesh(())
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.axis_name == sharding.DATA_AXIS == "data"
    with pytest.raises(ValueError, match="axis"):
        sharding.sharded_state_root(mesh, axis_name="model")


def test_make_mesh_takes_the_first_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharding.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert sharding.make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="3 devices requested, only 2 available"):
        sharding.make_mesh(3)


def test_parallel_exports_the_jax_names():
    from fisco_bcos_tpu import parallel as jparallel
    from fisco_bcos_tpu_torch import parallel

    names = {n for n in dir(jparallel) if n.startswith(("make_", "sharded_"))}
    assert names == {n for n in dir(parallel) if n.startswith(("make_", "sharded_"))}
    jax_makers = {n for n in dir(jsharding) if n.startswith("sharded_")}
    assert jax_makers == {n for n in dir(sharding) if n.startswith("sharded_")} and len(jax_makers) == 8


# -- the hash-only programs against the JAX programs ----------------------------


def test_state_root_matches_jax_program():
    digests = np.random.default_rng(SEED).integers(0, 2**32, size=(64, 8), dtype=np.uint32)
    want = np.asarray(jsharding.sharded_state_root(jsharding.make_mesh(8))(digests))
    for d in (1, 2, 8):
        got = sharding.sharded_state_root(cpu_mesh(d))(digests)
        assert got.dtype == torch.int32 and got.shape == (8,)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, np.bitwise_xor.reduce(digests, axis=0))
    # odd row counts in the halving loop, and an empty batch's zero root
    np.testing.assert_array_equal(
        sharding._xor_fold(torch.from_numpy(digests[:7].view(np.int32))).numpy().view(np.uint32),
        np.bitwise_xor.reduce(digests[:7], axis=0),
    )
    assert not sharding.sharded_state_root(cpu_mesh(2))(digests[:0]).any()


def _host_fold(nodes: list[bytes], width: int = 16) -> bytes:
    while len(nodes) > 1:
        nodes = [keccak256(b"".join(nodes[i : i + width])) for i in range(0, len(nodes), width)]
    return nodes[0]


@pytest.mark.parametrize("n", [128, 160])
def test_merkle_root_matches_jax_program(n):
    """128 leaves: 16 a shard, each shard's fold a node of the one-device
    tree; 160: 20 a shard, not a power of 16, against a host fold of the
    same shape too."""
    leaves = np.random.default_rng(SEED + n).integers(0, 256, size=(n, 32), dtype=np.uint8)
    want = bytes(np.asarray(jsharding.sharded_merkle_root(jsharding.make_mesh(8))(leaves)))
    got = sharding.sharded_merkle_root(cpu_mesh(8))(leaves)
    assert got.dtype == torch.uint8 and got.shape == (32,)
    assert bytes(got.numpy()) == want
    rows = [bytes(r) for r in leaves]
    k = n // 8
    assert want == _host_fold([_host_fold(rows[i * k : (i + 1) * k]) for i in range(8)])
    if n == 128:
        assert want == merkle.MerkleTree(leaves, device="cpu").padded_root


# -- the packed split ------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 4, 8])
def test_packed_split_hashes_every_lane_as_one_device(d):
    """Each shard's byte range, its starts rebased, gives every lane the
    one-device digest: shards that cut between payloads, and shards of only
    pad lanes (an empty range, hashed from a one-byte buffer)."""
    payloads = [b"tx %d " % i + b"z" * (i * 53 % 300) for i in range(11)]
    host = admission.host_inputs(payloads, np.zeros((11, 65), np.uint8))
    want = keccak.keccak256_packed(*(torch.from_numpy(a) for a in host[:3]))
    shards = sharding._packed_shards(cpu_mesh(d), *host)
    assert [len(s[1]) for s in shards] == [32 // d] * d
    got = torch.cat([keccak.keccak256_packed(*(torch.from_numpy(a) for a in s[:3])) for s in shards])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    last = shards[-1]
    assert last[0].size == 1 and not last[2].any() and not last[1].any()  # pad lanes only
    # the shards with payloads carry the data once, cut at lane boundaries
    assert b"".join(s[0].tobytes() for s in shards if s[2].any()) == host[0].tobytes()


# -- Ed25519 at D = 2 ----------------------------------------------------------------


def test_ed25519_verify_matches_one_device_call():
    """The 32 lanes of every kind of tests/test_torch_ed25519.py, padded to 64
    rows: shard 1 holds only the pad rows."""
    msgs, pubs, sigs = _columns(_lanes())
    rows = ed25519.device_inputs(msgs, pubs, sigs, pad_to=64)
    want = ed25519.verify_device(torch.from_numpy(rows))
    ok, n_valid = sharding.sharded_ed25519_verify(cpu_mesh(2))(rows)
    np.testing.assert_array_equal(ok.numpy(), want.numpy())
    assert n_valid.dtype == torch.int32 and int(n_valid) == int(want.sum())
    assert want[:32].any() and not want[:32].all()


# -- admission at D = 2, and the DevicePlane's fan-out ---------------------------


@pytest.fixture(scope="module")
def admissions():
    """9 payloads with the bad lanes of tests/test_torch_admission.py in the
    32-lane bucket (so shard 1 at D = 2 holds only pad lanes), and the
    one-device call through admit_batch with the plane off."""
    payloads = [b"tx %d " % i + b"z" * (i * 37 % 200) for i in range(9)]
    sigs, _ = _signed(payloads)
    sigs[6, 5] ^= 0xFF  # corrupted r
    sigs[7, 32:64] = 0  # s = 0
    sigs[8, 64] = 29  # v = 29
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        host = admission.host_inputs(payloads, sigs)
        packed = admission._admission_packed(*(torch.from_numpy(a) for a in host))
    return payloads, sigs, host, packed


def test_sharded_admission_matches_one_device_call(admissions):
    _, _, host, packed = admissions
    addr, ok, n_valid = sharding.sharded_admission(cpu_mesh(2))(*host)
    np.testing.assert_array_equal(addr.numpy(), packed[:, :20].numpy())
    np.testing.assert_array_equal(ok.numpy(), packed[:, 20].numpy() != 0)
    assert n_valid.dtype == torch.int32 and int(n_valid) == int(ok.sum()) > 0 and not ok[7:].any()


@pytest.fixture
def pushes(monkeypatch):
    """The ops of every device span, in order."""
    got: list = []
    real = dev_obs.LEDGER.push

    def spy(op, shape_key, batch):
        got.append((op, shape_key, batch))
        return real(op, shape_key, batch)

    monkeypatch.setattr(dev_obs.LEDGER, "push", spy)
    return got


def test_plane_fans_out_a_merged_admission(admissions, pushes, monkeypatch):
    """admit_batch with two devices of its kind and no threshold: through
    the plane, the sharded packed program (a shard of only pad lanes
    included) under ``admission_sharded``, equal to the one-device call;
    with the plane off, the one-device body under ``admission``."""
    payloads, sigs, host, packed = admissions
    want = admission._unpack(packed, len(payloads))
    monkeypatch.setenv("FISCO_DEVICE_SHARD_MIN", "0")
    monkeypatch.setattr(admission, "_local_devices", lambda dev: 2)
    monkeypatch.setattr(admission, "_SHARD_CACHE", {})
    monkeypatch.setattr(plane_mod, "_PLANE", DevicePlane())
    key = (32, admission.bucket_batch(int(host[2].max()) // keccak.RATE_BYTES + 1))
    got = admission.admit_batch(payloads, sigs, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [p for p in pushes if p[0].startswith("admission")] == [("admission_sharded", key, 9)]
    assert list(admission._SHARD_CACHE) == [("cpu", 2)]
    pushes.clear()
    monkeypatch.setenv("FISCO_DEVICE_PLANE", "0")
    got = admission.admit_batch(payloads, sigs, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [p for p in pushes if p[0].startswith("admission")] == [("admission", key, 9)]


def test_fan_out_follows_the_jax_rule(monkeypatch):
    """_maybe_sharded_step: more than one device, bb >= max(shard_min,
    devices), bb divisible by the devices; cached by kind and count; a mesh
    that cannot be built raises (no fallback)."""
    local_devices = admission._local_devices
    monkeypatch.setattr(admission, "_SHARD_CACHE", {})
    count = {"n": 2}
    monkeypatch.setattr(admission, "_local_devices", lambda dev: count["n"])
    monkeypatch.delenv("FISCO_DEVICE_SHARD_MIN", raising=False)
    assert admission._shard_min() == 4096
    assert admission._maybe_sharded_step(2048, CPU) is None
    step = admission._maybe_sharded_step(4096, CPU)
    assert step is not None and admission._maybe_sharded_step(8192, CPU) is step
    monkeypatch.setenv("FISCO_DEVICE_SHARD_MIN", "0")
    assert admission._maybe_sharded_step(32, CPU) is step
    count["n"] = 3
    assert admission._maybe_sharded_step(32, CPU) is None  # 32 % 3
    count["n"] = 64
    assert admission._maybe_sharded_step(32, CPU) is None  # fewer lanes than devices
    count["n"] = 1
    assert admission._maybe_sharded_step(32, CPU) is None
    monkeypatch.setenv("FISCO_DEVICE_SHARD_MIN", "not a number")
    assert admission._shard_min() == 4096
    # on CUDA the count is the cards'; a mesh that cannot be built raises
    monkeypatch.setattr(admission, "_local_devices", local_devices)
    monkeypatch.setenv("FISCO_DEVICE_SHARD_MIN", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert admission._local_devices(CPU) == 1 and admission._local_devices(torch.device("cuda", 0)) == 2
    with pytest.raises(RuntimeError, match="no CUDA"):
        admission._maybe_sharded_step(32, torch.device("cuda", 0))
