"""Fused tx-admission crypto step — the port's main path.

One device program performs, for a whole block of transactions, what the
reference does one tx at a time (``TxValidator::verify``,
bcos-txpool/txpool/validator/TxValidator.cpp:27-69). For the default suite
(:func:`admit_batch`):

    tx hash (keccak256)  →  ECDSA recover  →  sender = right160(keccak(pub))

and for an ``sm_crypto`` chain (:func:`admit_batch_sm`):

    tx hash (SM3)  →  SM2 "recover" (parse pub, verify)  →  right160(SM3(pub))

The batch enters as the packed payloads (one byte buffer plus per-payload
starts and lengths, which the hash kernels pad themselves) plus signature
limb tensors, and leaves as one packed ``[B, 117]`` uint8 tensor, copied to
the host once. The same body runs on either device: each hash and EC call
dispatches on its tensors' device, so on the card the path is the kernels
or an exception, with no host fallback. On the card each hash is a form of
its kernel that reads and writes what the EC kernel beside it gives and
takes (the tx hash also as limbs, the sender from the key's limbs, SM2's e
from the digests and key limbs), so no torch op runs between the launches:
``admit_batch`` is keccak256 2 + secp256k1_recover 1 launches,
``admit_batch_sm`` sm3 3 + sm2_verify 1. Invalid lanes never raise — they
lower a validity bit.

Both entry points ride the DevicePlane (``admission.<device>``,
``admission_sm.<device>``): concurrent callers' transactions merge into one
run of the body, sliced back a caller; ``FISCO_DEVICE_PLANE=0`` runs the
same body on the caller's thread. The body, on whichever thread runs it,
is one device span after its host half: ``admission`` keyed as the JAX
span is, (bucketed batch, bucketed keccak block count); and for the SM
suite, whose three JAX calls (``sm3`` tx hashes, ``sm2_verify``, ``sm3``
senders) run here as one fused body, one ``sm2_verify`` span, the op of
the signature work.

On the plane's worker, a merged ``admit_batch`` whose bucketed batch
clears ``FISCO_DEVICE_SHARD_MIN`` on a node with more than one card fans
out over all of them (``parallel/sharding.py sharded_admission_packed``)
under the span ``admission_sharded``, as the JAX plane's merged batches do
(JAX ``crypto/admission.py:118-147``). Unlike JAX, a failure of the mesh
or of a shard reaches the caller: there is no fallback.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..device.plane import in_plane_executor
from ..ops import keccak, secp256k1, sm2, sm3
from ..ops.address import sender_address_device, sm3_sender_address_device
from ..ops.bigint import bytes_be_to_limbs
from ..observability.device import device_span
from ..ops.hash_common import bucket_batch, pack_messages, pad_rows
from .suite import _routed


def admission_core(data, starts, lengths, r, s, v):
    """The fused admission body. (data, starts, lengths) are the packed
    signed payloads, one per lane; (r, s) [B, 16] int32 limbs and v [B]
    int32 are the 65-byte signature split.

    Returns (addr [B, 20] uint8, ok bool[B], pubkey [B, 64] uint8, tx hash
    [B, 32] uint8); a not-ok lane's pubkey is zero."""
    h, z = keccak.keccak256_tx_hash(data, starts, lengths)
    qx, qy, ok = secp256k1.recover_device(z, r, s, v)
    addr, pub = sender_address_device(qx, qy)
    return addr, ok, pub, h


def pack_admission_device(addr, ok, pub, h) -> torch.Tensor:
    """[B, 117] uint8 = addr(20) ‖ ok(1) ‖ pubkey(64) ‖ tx_hash(32)."""
    return torch.cat([addr, ok.to(torch.uint8)[:, None], pub, h], dim=1)


def _admission_packed(data, starts, lengths, r, s, v) -> torch.Tensor:
    return pack_admission_device(*admission_core(data, starts, lengths, r, s, v))


def _unpack(packed: torch.Tensor, n: int):
    out = packed[:n].cpu().numpy()
    return out[:, :20], out[:, 20] != 0, out[:, 21:85], out[:, 85:117]


def _signature_rows(payloads, sigs, width: int) -> np.ndarray:
    """The signatures as [B, width] uint8 rows, one a payload; another count
    raises: merged with other callers' rows, they would not line up."""
    sigs = np.asarray(sigs, dtype=np.uint8).reshape(-1, width)
    if len(sigs) != len(payloads):
        raise ValueError(f"{len(payloads)} payloads against {len(sigs)} signatures")
    return sigs


def admit_batch(
    payloads, sigs65, device=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host API: list[bytes] signed payloads + [B, 65] r‖s‖v signatures ->
    (senders [B, 20] uint8, ok bool[B], pubkeys [B, 64] uint8,
    tx hashes [B, 32] uint8).

    Runs on the CUDA card unless ``device`` names another; with no device
    and no CUDA it raises. A not-ok lane carries a zero pubkey and the
    sender of the zero key, right160(keccak(0^64)), as the JAX device
    program does."""
    dev = resolve_device(device)
    payloads = list(payloads)
    sigs65 = _signature_rows(payloads, sigs65, 65)
    return _routed(f"admission.{dev}", (payloads, sigs65), len(payloads),
                   lambda p, s: _admit_direct(p, s, dev, allow_shard=in_plane_executor()))


def _admit_direct(payloads, sigs65, dev, allow_shard: bool = False):
    """The admission body on this thread. `allow_shard` (the plane's worker
    only) fans the bucketed batch out over the local cards when it clears
    the threshold (:func:`_maybe_sharded_step`)."""
    host = host_inputs(payloads, sigs65)
    # the JAX span's key, from the shape pad_keccak gives the same payloads:
    # (bucketed batch, bucketed block count of the longest lane)
    lengths = host[2]
    bb = len(lengths)
    key = (bb, bucket_batch(int(lengths.max()) // keccak.RATE_BYTES + 1))
    step = _maybe_sharded_step(bb, dev) if allow_shard else None
    with device_span("admission" if step is None else "admission_sharded", len(payloads), shape_key=key):
        if step is None:
            packed = _admission_packed(*(torch.from_numpy(a).to(dev) for a in host))
        else:
            packed = step(*host)
        return _unpack(packed, len(payloads))


# -- multi-device fan-out -----------------------------------------------------

_SHARD_CACHE: dict[tuple[str, int], object] = {}


def _shard_min() -> int:
    """Bucketed-batch floor for the fan-out (JAX ``_shard_min``, its knob
    and default): below thousands of lanes one card is faster than the
    split and the gather."""
    try:
        return int(os.environ.get("FISCO_DEVICE_SHARD_MIN", "4096"))
    except ValueError:
        return 4096


def _local_devices(dev: torch.device) -> int:
    """The devices of `dev`'s kind a batch may fan out over: every CUDA
    card; the CPU is one device."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _maybe_sharded_step(bb: int, dev: torch.device):
    """The sharded admission program, cached by device kind and count, when
    the bucketed batch `bb` on `dev` clears the JAX rule: more than one
    device, bb >= max(shard_min, devices) and bb divisible by the devices;
    None otherwise (the one-device body). Nothing is caught: a mesh that
    cannot be built raises to the caller."""
    ndev = _local_devices(dev)
    if ndev <= 1 or bb < max(_shard_min(), ndev) or bb % ndev:
        return None
    step = _SHARD_CACHE.get((dev.type, ndev))
    if step is None:
        from ..parallel.sharding import Mesh, make_mesh, sharded_admission_packed

        mesh = make_mesh(ndev) if dev.type == "cuda" else Mesh((dev,) * ndev)
        step = _SHARD_CACHE[(dev.type, ndev)] = sharded_admission_packed(mesh)
    return step


def _packed_payloads(payloads, lanes: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pack_messages of the payloads, with empty messages as pad lanes up
    to `lanes` (the bucketed batch, as the JAX padding fills it)."""
    data, starts, lengths = pack_messages(payloads)
    pad = lanes - len(lengths)
    return (
        data,
        np.concatenate([starts, np.full(pad, data.size, dtype=np.int64)]),
        np.concatenate([lengths, np.zeros(pad, dtype=np.int32)]),
    )


def host_inputs(payloads, sigs65) -> tuple[np.ndarray, ...]:
    """The host half of admission: (data uint8 [N], starts int64 [B'],
    lengths int32 [B'], r, s [B', 16] int32 limbs, v [B'] int32), B' the
    bucketed batch; its pad lanes hash the empty message and carry zero
    signatures."""
    bb = bucket_batch(max(len(payloads), 1))
    sigs65 = np.asarray(sigs65, dtype=np.uint8).reshape(-1, 65)

    def limbs(a):
        return pad_rows(bytes_be_to_limbs(a), bb).astype(np.int32)

    return (
        *_packed_payloads(payloads, bb),
        limbs(sigs65[:, :32]),
        limbs(sigs65[:, 32:64]),
        pad_rows(sigs65[:, 64].astype(np.int32), bb),
    )


# ---------------------------------------------------------------------------
# SM suite (sm_crypto chains): SM3 + SM2
# ---------------------------------------------------------------------------


def admission_sm_core(data, starts, lengths, r, s, qx, qy):
    """The SM admission body. (data, starts, lengths) are the packed signed
    payloads, one per lane; r, s, qx, qy [B, 16] int32 limbs of r‖s‖pub.

    Returns (addr [B, 20] uint8, ok bool[B], pubkey [B, 64] uint8 zeroed on
    not-ok lanes, tx hash [B, 32] uint8). The tx hash is the packed form:
    nothing on this path reads it as limbs (SM2 takes e)."""
    h = sm3.sm3_packed(data, starts, lengths)
    e = sm2.e_device(h, qx, qy)
    ok = sm2.verify_device(e, r, s, qx, qy)
    addr, pub = sm3_sender_address_device(qx, qy, ok)
    return addr, ok, pub, h


def admit_batch_sm(
    payloads, sigs128, device=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host API of the SM suite: list[bytes] signed payloads + [B, 128]
    r‖s‖pubkey signatures -> (senders [B, 20] uint8, ok bool[B], pubkeys
    [B, 64] uint8, tx hashes [B, 32] uint8).

    One call for the three steps that the JAX package's ``batch_admit``
    takes on a non-default suite (txpool/validator.py:143-149):
    ``sm3_batch(payloads)`` → ``sm2.recover_batch(hashes, sigs128)`` (parse
    the pubkey, verify, zero the pubkey of a not-ok lane) →
    ``sm3_batch(pubs)[:, 12:]`` (crypto/suite.py:940). A not-ok lane
    therefore carries the zero key and its sender right160(SM3(0^64)).

    Runs on the CUDA card unless ``device`` names another; with no device
    and no CUDA it raises. An empty batch returns before any device work,
    as ``batch_admit`` does."""
    dev = resolve_device(device)
    if not len(payloads):
        return _unpack(torch.zeros((0, 117), dtype=torch.uint8), 0)
    payloads = list(payloads)
    sigs128 = _signature_rows(payloads, sigs128, 128)
    return _routed(f"admission_sm.{dev}", (payloads, sigs128), len(payloads),
                   lambda p, s: _admit_sm_direct(p, s, dev))


def _admit_sm_direct(payloads, sigs128, dev):
    host = host_inputs_sm(payloads, sigs128)
    n = len(payloads)
    with device_span("sm2_verify", n, shape_key=bucket_batch(n)) as sp:
        with sp.phase("transfer"):  # host->card copies of the operands
            tensors = [torch.from_numpy(a).to(dev) for a in host]
        packed = pack_admission_device(*admission_sm_core(*tensors))
        return _unpack(packed, n)


def host_inputs_sm(payloads, sigs128) -> tuple[np.ndarray, ...]:
    """The host half of SM admission: (data uint8 [N], starts int64 [B'],
    lengths int32 [B'], r, s, qx, qy [B', 16] int32 limbs), B' the bucketed
    batch; its pad lanes hash the empty message and carry zero signatures."""
    bb = bucket_batch(max(len(payloads), 1))
    sigs128 = pad_rows(np.asarray(sigs128, dtype=np.uint8).reshape(-1, 128), bb)
    limbs = [bytes_be_to_limbs(sigs128[:, i : i + 32]).astype(np.int32) for i in range(0, 128, 32)]
    return (*_packed_payloads(payloads, bb), *limbs)
