"""The port's fused admission (plain PyTorch on the CPU) against the JAX
package's device program, bytewise on every lane of the bucket."""

import numpy as np
import pytest

from fisco_bcos_tpu.crypto import admission as jadmission
from fisco_bcos_tpu_torch.crypto import admission
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.ops import _kernels


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
