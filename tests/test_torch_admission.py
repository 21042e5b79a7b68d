"""The port's fused admission (plain PyTorch on the CPU) against the JAX
package's device program, bytewise on every lane of the bucket; and the
hash kernels' tx-hash and sender forms (their CPU entries) against the same
program's tx hashes, senders and keys."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import admission as jadmission
from fisco_bcos_tpu_torch.crypto import admission
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3
from fisco_bcos_tpu_torch.ops import _kernels, address, keccak
from fisco_bcos_tpu_torch.ops.bigint import bytes_be_to_limbs


def _signed(payloads):
    sigs, pubs = [], []
    for i, p in enumerate(payloads):
        d = 0xA11CE + 31337 * i
        r, s, v = ref.ecdsa_sign(keccak256(p), d)
        sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v]))
        pubs.append(ref.privkey_to_pubkey(ref.SECP256K1, d))
    return np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(-1, 65).copy(), pubs


@pytest.fixture(scope="module")
def admitted():
    # the payload lengths of tests/test_admission.py: one and two rate blocks
    payloads = [b"tx %d " % i + b"z" * (i * 37 % 200) for i in range(9)]
    sigs, pubs = _signed(payloads)
    sigs[6, 5] ^= 0xFF  # corrupted r: another key, or none
    sigs[7, 32:64] = 0  # s = 0: not ok
    sigs[8, 64] = 29  # must not alias to recovery id 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        port = admission.admit_batch(payloads, sigs, device="cpu")
        mp.setenv("FISCO_FORCE_DEVICE_ADMISSION", "1")  # the JAX device program
        ref_out = jadmission.admit_batch(payloads, sigs)
    return payloads, pubs, port, ref_out


def test_admission_matches_jax_device_program(admitted):
    _, _, port, ref_out = admitted
    for name, got, want in zip(("senders", "ok", "pubkeys", "tx hashes"), port, ref_out):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_admission_matches_reference(admitted):
    payloads, pubs, (senders, ok, pubkeys, hashes), _ = admitted
    assert senders.dtype == pubkeys.dtype == hashes.dtype == np.uint8
    assert ok[:6].all() and not ok[7:].any()
    for j, p in enumerate(payloads):
        assert bytes(hashes[j]) == keccak256(p)
        if j < 6:
            x, y = pubs[j]
            pub = x.to_bytes(32, "big") + y.to_bytes(32, "big")
            assert bytes(pubkeys[j]) == pub
        else:
            pub = bytes(pubkeys[j])
        if not ok[j]:
            assert pub == bytes(64)  # a not-ok lane carries the zero key ...
        assert bytes(senders[j]) == keccak256(pub)[12:]  # ... and its sender


def test_admission_empty_batch():
    senders, ok, pubkeys, hashes = admission.admit_batch([], np.zeros((0, 65), np.uint8), device="cpu")
    assert senders.shape == (0, 20) and ok.shape == (0,)
    assert pubkeys.shape == (0, 64) and hashes.shape == (0, 32)


@pytest.fixture
def cpu_only(monkeypatch):
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))


def _key_limbs(pubkeys):
    pubkeys = np.asarray(pubkeys)
    return [torch.from_numpy(bytes_be_to_limbs(pubkeys[:, i : i + 32]).astype(np.int32)) for i in (0, 32)]


def test_tx_hash_form_matches_jax_admission(admitted, cpu_only):
    """keccak256_tx_hash on the packed payloads: the digests are the JAX
    program's tx hashes, and z their limbs."""
    payloads, _, _, ref_out = admitted
    host = admission.host_inputs(payloads, np.zeros((len(payloads), 65), np.uint8))
    h, z = keccak.keccak256_tx_hash(*(torch.from_numpy(a) for a in host[:3]))
    want = np.asarray(ref_out[3])
    np.testing.assert_array_equal(h.numpy()[: len(payloads)], want)
    np.testing.assert_array_equal(z.numpy()[: len(payloads)], bytes_be_to_limbs(want).astype(np.int32))
    assert h.shape[0] == z.shape[0] == host[3].shape[0]  # the pad lanes hash the empty message
    assert {bytes(row) for row in h.numpy()[len(payloads):]} <= {keccak256(b"")}


def test_keccak_sender_form_matches_jax_admission(admitted, cpu_only):
    """The keccak sender form from the recovered keys' limbs: the JAX
    program's senders and keys, a not-ok lane's zero key and its sender
    right160(keccak(0^64)) included."""
    _, _, _, (jsenders, jok, jpubs, _) = admitted
    addr, pub = address.sender_address_device(*_key_limbs(jpubs))
    np.testing.assert_array_equal(addr.numpy(), np.asarray(jsenders))
    np.testing.assert_array_equal(pub.numpy(), np.asarray(jpubs))
    assert not np.asarray(jok).all()
    for row in addr.numpy()[~np.asarray(jok)]:
        assert bytes(row) == keccak256(bytes(64))[12:]


def test_sm3_sender_form_zeroes_not_ok_lanes(admitted, cpu_only):
    """The SM3 sender form on the same keys with an ok mask: the key rows
    zeroed where ok is false, and each sender right160(SM3(row)), so
    right160(SM3(0^64)) on a not-ok lane."""
    _, pubs, _, _ = admitted
    keys = np.stack([np.frombuffer(x.to_bytes(32, "big") + y.to_bytes(32, "big"), np.uint8) for x, y in pubs])
    ok = np.arange(len(keys)) % 3 != 1
    addr, pub = address.sm3_sender_address_device(*_key_limbs(keys), torch.from_numpy(ok))
    np.testing.assert_array_equal(pub.numpy(), np.where(ok[:, None], keys, 0))
    for i, row in enumerate(pub.numpy()):
        assert bytes(addr.numpy()[i]) == sm3(bytes(row))[12:]
    assert bytes(addr.numpy()[1]) == sm3(bytes(64))[12:]
