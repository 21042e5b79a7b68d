"""The port's sharded secp256k1 verify, QC check and SM2 verify
(``fisco_bcos_tpu_torch/parallel/sharding.py``) on a CPU mesh of two
entries, against the port's one-device calls lane for lane, on every lane
kind of tests/test_torch_verify.py and tests/test_torch_sm2.py padded to 64
rows, so that the second shard holds only pad rows. Each plain EC batch
costs seconds on the CPU, whatever its lanes: the rest of the fan-out's
tests are in test_torch_sharding.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3 as ref_sm3
from fisco_bcos_tpu_torch.ops import _kernels, bigint, secp256k1, sm2
from fisco_bcos_tpu_torch.parallel import sharding
from fisco_bcos_tpu_torch.parallel.sharding import Mesh

from test_torch_sm2 import _cases, _edge_e_rows
from test_torch_verify import _arrays, _oracle, _vectors

ROWS = 64  # two shards of 32: the real lanes in the first, pad rows in the second
MESH = Mesh((torch.device("cpu"),) * 2)


@pytest.fixture(autouse=True)
def cpu_only(monkeypatch):
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))


@pytest.fixture(scope="module")
def verify_rows():
    """Every verify lane kind, [64, 160] rows, and the one-device verdicts."""
    vectors = _vectors()
    assert len(vectors) <= ROWS // 2
    rows = secp256k1.verify_rows(*_arrays(vectors), ROWS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        want = secp256k1.verify_device(torch.from_numpy(rows)).numpy()
    assert want[: len(vectors)].tolist() == _oracle(vectors)
    return rows, want


def test_sharded_verify_matches_one_device_call(verify_rows):
    rows, want = verify_rows
    ok, n_valid = sharding.sharded_verify(MESH)(rows)
    assert ok.dtype == torch.bool and ok.shape == (ROWS,)
    np.testing.assert_array_equal(ok.numpy(), want)
    assert n_valid.dtype == torch.int32 and n_valid.shape == () and int(n_valid) == want.sum()


def test_sharded_qc_check_sums_the_valid_weights(verify_rows):
    rows, want = verify_rows
    weights = np.random.default_rng(20_261_018).integers(1, 1000, size=ROWS, dtype=np.int32)
    ok, weight = sharding.sharded_qc_check(MESH)(rows, weights)
    np.testing.assert_array_equal(ok.numpy(), want)
    assert weight.dtype == torch.int32 and int(weight) == int(weights[want].sum())


def _limb_column(vals) -> np.ndarray:
    vals = list(vals) + [0] * (ROWS - len(vals))
    return np.stack([bigint.int_to_limbs(v) for v in vals]).astype(np.int32)


def test_sharded_sm2_verify_matches_one_device_call():
    """The SM2 lane kinds (e = SM3(ZA ‖ M) on the host) and the edge digests
    e = 0, 2^256 - 1, n, n - 1, as [64, 16] int32 limbs."""
    lanes = [(ref.sm2_e(ref_sm3(p), q), r, s, q) for p, r, s, q in _cases()]
    lanes += _edge_e_rows()[: ROWS // 2 - len(lanes)]
    e, r, s, qx, qy = (
        _limb_column(col)
        for col in zip(*[(e, r, s, q[0], q[1]) for e, r, s, q in lanes])
    )
    want = sm2.verify_device(*(torch.from_numpy(a) for a in (e, r, s, qx, qy))).numpy()
    assert want[: len(lanes)].tolist() == [ref.sm2_verify_e(*lane) for lane in lanes]
    ok, n_valid = sharding.sharded_sm2_verify(MESH)(e, r, s, qx, qy)
    np.testing.assert_array_equal(ok.numpy(), want)
    assert n_valid.dtype == torch.int32 and int(n_valid) == want.sum() > 0
