"""Device-mesh fan-out for the batch crypto plane (the port of the JAX
package's ``parallel/sharding.py``).

The reference scales its hot verify loops with ``tbb::parallel_for`` over CPU
threads (bcos-txpool/sync/TransactionSync.cpp:521-553) and its state hash the
same way (bcos-table/src/StateStorage.h:457-486). The JAX package shards a
batch over the ``data`` axis of a ``jax.sharding.Mesh`` with ``shard_map``;
here a :class:`Mesh` is an ordered tuple of ``torch.device`` s, and each
program is the same body run once a device on that device's rows:

- the batch rows split into one equal block a device (a batch that does not
  split raises ``ValueError``, as ``shard_map`` refuses it); each block goes
  from the host straight to its device;
- each block's body runs under ``torch.cuda.device`` of its device, on a
  stream of its own when the mesh has more than one entry (on the caller's
  current stream when it has one), with no host sync inside it, so the
  shards' kernels overlap;
- each shard's outputs come to the mesh's first device, in shard order,
  after an event recorded on the shard's stream: ``all_gather(tiled=True)``
  is a ``torch.cat`` there, ``psum`` a sum, and the XOR fold of the state
  root a halving loop of ``torch.bitwise_xor`` (torch has no XOR
  reduction). The outputs come back once, on the first device: the
  single-process form of JAX's replicated ``P()`` outputs.

A mesh may name one device several times. Each entry is a shard of its own,
on a stream of its own: a logical mesh over one card, or over the CPU, where
the bodies run the kernels' plain versions one shard after another.

Each program keeps the JAX program's outputs. Its inputs are the port's
one-device forms, the rows and limbs the port's kernels take (JAX's take
limbs): ``secp256k1.verify_device``'s ``[B, 160]`` rows, SM2's five ``[B,
16]`` int32 limb arrays, Ed25519's ``[B, 128]`` rows from ``device_inputs``,
and admission's packed ``host_inputs``. Inputs are host arrays (numpy, or
CPU tensors).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..crypto.admission import _admission_packed, admission_core
from ..ops import ed25519, secp256k1, sm2
from ..ops.keccak import keccak256_packed
from ..ops.merkle import _level

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: an ordered tuple of devices of one type and the
    name of its one axis (what ``jax.sharding.Mesh(np.asarray(devs),
    (axis,))`` is to the JAX package). A device may appear more than once;
    each appearance is a shard of its own."""

    devices: tuple
    axis_name: str = DATA_AXIS

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in devs})
        if len(kinds) > 1:
            raise ValueError(f"a mesh holds devices of one type, got {kinds}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first `n_devices` CUDA cards (all of them by
    default). Without CUDA it raises: a mesh of other devices is built by
    naming them, ``Mesh((torch.device("cpu"),) * n)``."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device available; name the devices of a Mesh to run elsewhere")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"make_mesh: {n} devices requested, only {len(devs)} available")
    return Mesh(tuple(devs[:n]), axis_name)


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's axis {mesh.axis_name!r}")


# ---------------------------------------------------------------------------
# The fan-out: split, upload, run a shard a device, gather
# ---------------------------------------------------------------------------


def _row_shards(mesh: Mesh, *arrays) -> list[tuple]:
    """The arrays' rows in ``mesh.size`` equal blocks: shard i's tuple of
    host slices, one an array."""
    n = arrays[0].shape[0]
    if any(a.shape[0] != n for a in arrays):
        raise ValueError(f"inputs of {[a.shape[0] for a in arrays]} rows: one batch has one row count")
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.size} devices")
    k = n // mesh.size
    return [tuple(a[i * k : (i + 1) * k] for a in arrays) for i in range(mesh.size)]


def _upload(arrays, dev: torch.device) -> list[torch.Tensor]:
    return [
        (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))).contiguous().to(dev)
        for a in arrays
    ]


@lru_cache(maxsize=None)
def _shard_stream(dev: torch.device, shard: int) -> torch.cuda.Stream:
    """The stream of a mesh's entry `shard` on `dev`, the same at every
    call: the caching allocator keeps a stream's freed blocks for that
    stream, so a shard's next call reuses them instead of allocating."""
    return torch.cuda.Stream(dev)


def _fan_out(mesh: Mesh, shards: list[tuple], body) -> list[tuple]:
    """``body(*tensors)`` of shard i on device i, its host arrays uploaded
    there; returns each shard's output tensors on the mesh's first device,
    in shard order. On CUDA each shard runs under its device and, when the
    mesh has more than one entry, on a stream of its own
    (:func:`_shard_stream`) that first waits for the caller's stream; its
    outputs are read after an event recorded on that stream, and recorded
    for the allocator on the stream that reads them (a copy across cards
    runs on the source card's current stream)."""
    first = mesh.devices[0]
    if first.type != "cuda":
        return [tuple(t.to(first) for t in body(*_upload(arrays, dev))) for dev, arrays in zip(mesh.devices, shards)]
    if mesh.size == 1:
        with torch.cuda.device(first):
            return [tuple(body(*_upload(shards[0], first)))]
    # each shard's upload just before its body: the host uploads shard i + 1
    # while shard i's kernels run
    launched = []
    for i, (dev, arrays) in enumerate(zip(mesh.devices, shards)):
        with torch.cuda.device(dev):
            stream = _shard_stream(dev, i)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                outs = tuple(body(*_upload(arrays, dev)))
                done = torch.cuda.Event()
                done.record(stream)
        launched.append((dev, done, outs))
    gathered = []
    for dev, done, outs in launched:
        reader = torch.cuda.current_stream(dev)
        reader.wait_event(done)
        for t in outs:
            t.record_stream(reader)
        gathered.append(tuple(t.to(first) for t in outs))
    return gathered


def _tiled(outs: list[tuple], k: int) -> torch.Tensor:
    """``all_gather(tiled=True)`` of output k: the shards' blocks in order."""
    parts = [o[k] for o in outs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _psum(outs: list[tuple], k: int) -> torch.Tensor:
    """``psum`` of output k, a 0-d int32 a shard."""
    return torch.stack([o[k] for o in outs]).sum(dtype=torch.int32)


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """The XOR of the rows of x [n, w] (zeros for n = 0), by halving."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = x[:half] ^ x[half : 2 * half]
        x = torch.cat([folded, x[2 * half :]]) if x.shape[0] % 2 else folded
    return x[0]


def _ok_and_count(ok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ok, ok.sum(dtype=torch.int32)


def _ok_programs(mesh: Mesh, local):
    """fn(*arrays) -> (ok bool[B], n_valid int32[]) of a verify body
    `local`, the arrays split by rows."""

    def run(*arrays):
        outs = _fan_out(mesh, _row_shards(mesh, *arrays), lambda *t: _ok_and_count(local(*t)))
        return _tiled(outs, 0), _psum(outs, 1)

    return run


# ---------------------------------------------------------------------------
# The eight programs
# ---------------------------------------------------------------------------


def sharded_verify(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Batch-sharded secp256k1 verify: fn(rows [B, 160] uint8, z ‖ r ‖ s ‖
    qx ‖ qy big-endian, as ``secp256k1.verify_rows`` makes them) -> (ok
    bool[B], n_valid int32[]), B divisible by the mesh size; both on the
    mesh's first device."""
    _check_axis(mesh, axis_name)
    return _ok_programs(mesh, secp256k1.verify_device)


def sharded_admission(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Batch-sharded fused admission (hash -> recover -> address):
    fn(data, starts, lengths, r, s, v), the packed form of
    ``crypto.admission.host_inputs`` -> (addr [B, 20] uint8, ok bool[B],
    n_valid int32[]) on the mesh's first device. The body is
    ``admission_core``; see :func:`sharded_admission_packed` for the
    split."""
    _check_axis(mesh, axis_name)

    def local(data, starts, lengths, r, s, v):
        addr, ok, _pub, _h = admission_core(data, starts, lengths, r, s, v)
        return addr, *_ok_and_count(ok)

    def run(*host):
        outs = _fan_out(mesh, _packed_shards(mesh, *host), local)
        return _tiled(outs, 0), _tiled(outs, 1), _psum(outs, 2)

    return run


def _packed_shards(mesh: Mesh, data, starts, lengths, *rows) -> list[tuple]:
    """host_inputs' packed form split over the mesh: the lanes (starts,
    lengths and the signature rows) in equal blocks, and shard i's bytes the
    range its lanes cover, starts rebased to it. A shard whose range is
    empty (only pad lanes, which start at the end of the data with length
    0) gets a one-byte buffer, so every launch reads a real allocation."""
    data, starts, lengths = np.asarray(data), np.asarray(starts), np.asarray(lengths)
    shards = []
    for st, ln, *rest in _row_shards(mesh, starts, lengths, *rows):
        lo = int(st.min()) if st.size else 0
        hi = int((st + ln).max()) if st.size else 0
        buf = data[lo:hi] if hi > lo else np.zeros(1, dtype=np.uint8)
        shards.append((buf, st - lo, ln, *rest))
    return shards


def sharded_admission_packed(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Fan-out form of the packed one-transfer admission (the
    DevicePlane's multi-device leg for merged batches above
    ``FISCO_DEVICE_SHARD_MIN``): fn(data, starts, lengths, r, s, v), the
    packed form of ``crypto.admission.host_inputs`` -> [B, 117] uint8
    (addr ‖ ok ‖ pubkey ‖ tx hash) on the mesh's first device, for one
    download. Each device runs ``_admission_packed``, the one-device body,
    on its block of lanes, which carries the bytes its lanes cover, so the
    result is the one-device program's lane for lane. B divisible by the
    mesh size (the bucket ladder gives it for power-of-two meshes)."""
    _check_axis(mesh, axis_name)

    def run(*host):
        return _tiled(_fan_out(mesh, _packed_shards(mesh, *host), lambda *t: (_admission_packed(*t),)), 0)

    return run


def sharded_sm2_verify(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Batch-sharded SM2 verify: fn(e, r, s, qx, qy [B, 16] int32 plain
    limbs, e = SM3(ZA ‖ M)) -> (ok bool[B], n_valid int32[]) on the mesh's
    first device."""
    _check_axis(mesh, axis_name)
    return _ok_programs(mesh, sm2.verify_device)


def sharded_ed25519_verify(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Batch-sharded Ed25519 verify: fn(rows [B, 128] uint8, R ‖ S ‖ A ‖
    k_neg as ``ed25519.device_inputs`` makes them) -> (ok bool[B], n_valid
    int32[]) on the mesh's first device."""
    _check_axis(mesh, axis_name)
    return _ok_programs(mesh, ed25519.verify_device)


def sharded_merkle_root(mesh: Mesh, width: int = 16, axis_name: str = DATA_AXIS):
    """Batch-sharded wide-merkle keccak root: fn(leaves [N, 32] uint8) ->
    [32] uint8 on the mesh's first device.

    Each shard folds its block of leaves to ONE node (``ops.merkle._level``,
    a launch of the packed keccak kernel a level), the D nodes are gathered
    and the top is folded on the first device: the JAX program's root for
    every N divisible by D, and the one-device tree's when the leaves a
    shard are a power of `width`. Emits the bucket-PADDED root (callers pad
    N to ``ops.merkle.bucket_leaves`` and finish with ``bind_root``)."""
    _check_axis(mesh, axis_name)

    def fold(cur: torch.Tensor) -> torch.Tensor:
        while cur.shape[0] > 1:
            cur = _level(cur, width, keccak256_packed)
        return cur

    def run(leaves):
        if leaves.ndim != 2 or leaves.shape[1] != 32 or leaves.shape[0] == 0:
            raise ValueError("leaves must be [N, 32] uint8, N >= 1")
        return fold(_tiled(_fan_out(mesh, _row_shards(mesh, leaves), lambda t: (fold(t),)), 0))[0]

    return run


def sharded_qc_check(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Batch-sharded block-QC signature-list check (the reference's #2 hot
    loop, bcos-pbft BlockValidator.cpp:141-177): fn(rows [B, 160] uint8 as
    :func:`sharded_verify` takes them, weights [B] int32) -> (ok bool[B],
    weight int32[], the sum of the VALID signers' weights, which the caller
    compares with the quorum), on the mesh's first device."""
    _check_axis(mesh, axis_name)

    def local(rows, weights):
        ok = secp256k1.verify_device(rows)
        return ok, torch.where(ok, weights, 0).sum(dtype=torch.int32)

    def run(rows, weights):
        outs = _fan_out(mesh, _row_shards(mesh, rows, weights), local)
        return _tiled(outs, 0), _psum(outs, 1)

    return run


def sharded_state_root(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Order-independent XOR state root over sharded entry digests (the
    reference folds dirty-entry hashes with XOR under tbb,
    StateStorage.h:457-486): fn(digests [B, 8] uint32 words) -> [8] int32
    on the mesh's first device, bit for bit the JAX program's uint32 words
    (torch's uint32 is partial, so the words ride as int32). Each shard
    folds its block, the D partial roots are gathered and folded."""
    _check_axis(mesh, axis_name)

    def run(digests):
        if isinstance(digests, torch.Tensor):
            words = digests.view(torch.int32)
        else:
            words = np.asarray(digests, dtype=np.uint32).view(np.int32)
        outs = _fan_out(mesh, _row_shards(mesh, words), lambda t: (_xor_fold(t),))
        return _xor_fold(torch.stack([o[0] for o in outs]))

    return run
