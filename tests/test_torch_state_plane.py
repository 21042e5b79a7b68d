"""The JAX node's succinct state plane on the port's Poseidon, on the CPU
(``device="cpu"``): ``fisco_bcos_tpu.succinct.state_plane.StatePlane`` with
``hasher="poseidon"`` builds its commitment suite and checks its proofs
through the port's ``CryptoSuite`` and ``hash_impl_by_name`` (swapped into
the module, as tests/test_torch_node_seam.py swaps the node's suite), so its
leaf hashing and page and top trees ride the port's DevicePlane and its
plain Poseidon. While the port serves, every JAX Poseidon batch entry
(``ops.poseidon.poseidon_batch(_async)`` and the JAX merkle hasher) is
patched to fail. The bootstrap and preview commitments are held against the
JAX package's full-recompute walker ``reference_state_commitment``, the
served proofs against ``verify_state_proof`` through the port and through
the JAX package alone, and tampered proofs must fail."""

import os
from dataclasses import replace

import pytest
import torch

from fisco_bcos_tpu.ops import merkle as jmerkle
from fisco_bcos_tpu.ops import poseidon as jposeidon
from fisco_bcos_tpu.storage.entry import Entry, EntryStatus
from fisco_bcos_tpu.succinct import state_plane as sp
from fisco_bcos_tpu_torch.crypto import suite
from fisco_bcos_tpu_torch.ops import _kernels, merkle

N_PAGES = 2


class FakeLedger:
    def __init__(self):
        self.hashes = {0: b"\x11" * 32}
        self.number = 0

    def block_number(self):
        return self.number

    def block_hash_by_number(self, n):
        return self.hashes.get(n)


class FakeBackend:
    def __init__(self):
        self.rows = {}

    def traverse(self):
        for (t, k), e in self.rows.items():
            yield t, k, e.copy()


def _rows(live: dict) -> list:
    return [(t, k, e) for (t, k), e in live.items()]


@pytest.fixture
def port_poseidon(monkeypatch):
    """The state plane's suite and proof hashes from the port, every JAX
    Poseidon batch entry made to fail; yields the port's packed Poseidon
    calls (lanes a call)."""

    def jax_batch(name):
        def fail(*_args, **_kwargs):
            pytest.fail(f"a JAX Poseidon batch entry ran: {name}")

        return fail

    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
    monkeypatch.setattr(jposeidon, "poseidon_batch", jax_batch("ops.poseidon.poseidon_batch"))
    monkeypatch.setattr(jposeidon, "poseidon_batch_async", jax_batch("ops.poseidon.poseidon_batch_async"))
    monkeypatch.setitem(jmerkle._HASHERS, "poseidon", jax_batch("ops.merkle._HASHERS['poseidon']"))
    def on_cpu(name):
        suite.hasher_fns(name)  # raises for a hasher the port does not carry
        return suite._HASH_IMPLS[name](torch.device("cpu"))

    monkeypatch.setattr(sp, "CryptoSuite", suite.CryptoSuite)
    monkeypatch.setattr(sp, "hash_impl_by_name", on_cpu)
    calls = []
    packed, host = merkle._HASHERS["poseidon"]

    def counted(data, starts, lengths):
        calls.append(int(starts.shape[0]))
        return packed(data, starts, lengths)

    monkeypatch.setitem(merkle._HASHERS, "poseidon", (counted, host))
    monkeypatch.setattr(suite.poseidon_ops, "poseidon_packed", counted)
    yield calls


def test_state_plane_commitments_and_proofs_on_the_port(port_poseidon, monkeypatch):
    ledger, backend = FakeLedger(), FakeBackend()
    for i in range(5):
        backend.rows[("t_seed", f"k{i}".encode())] = Entry().set(f"v{i}".encode())
    plane = sp.StatePlane(ledger, suite.ecdsa_suite(device="cpu"), backend=backend, hasher="poseidon",
                          n_pages=N_PAGES)
    assert isinstance(plane.suite, suite.CryptoSuite) and isinstance(plane.suite.hash_impl, suite.Poseidon)
    live = dict(backend.rows)
    assert plane.head_commitment() == sp.reference_state_commitment(_rows(live), "poseidon", N_PAGES)
    assert port_poseidon and port_poseidon[0] == 10  # the leaf batch: 5 key blobs, 5 leaf preimages

    # block 1: two updates, an insert and a delete
    writes = [
        ("t_seed", b"k0", Entry().set(b"v0 updated")),
        ("t_seed", b"k3", Entry().set(os.urandom(8))),
        ("t_new", b"fresh", Entry().set(b"inserted")),
        ("t_seed", b"k4", Entry(status=EntryStatus.DELETED)),
    ]
    for t, k, e in writes:
        if e.deleted:
            live.pop((t, k))
        else:
            live[(t, k)] = e
    commitment = plane.preview(1, writes)
    assert commitment == sp.reference_state_commitment(_rows(live), "poseidon", N_PAGES)
    ledger.hashes[1] = b"\x22" * 32
    ledger.number = 1
    plane.promote(1, ledger.hashes[1])
    assert plane.head_commitment() == commitment

    reqs = [("t_seed", b"k0"), ("t_new", b"fresh"), ("t_seed", b"k1"), ("t_seed", b"k4")]
    served = plane.state_proof_batch(reqs)
    assert served[-1] is None  # deleted: no proof
    proofs = list(zip(reqs[:-1], served[:-1]))
    for (t, k), res in proofs:
        assert res.commitment == commitment and res.entry_bytes == live[(t, k)].encode()
        assert sp.verify_state_proof(t, k, res, commitment, hasher="poseidon", n_pages=N_PAGES)
    (t, k), res = proofs[0]
    tampered = [
        replace(res, entry_bytes=b"tampered"),
        replace(res, page=1 - res.page),
        replace(res, leaf_index=(res.leaf_index + 1) % max(res.n_leaves, 2)),
        replace(res, top_items=res.top_items[:-1]),
    ]
    assert not any(sp.verify_state_proof(t, k, bad, commitment, hasher="poseidon", n_pages=N_PAGES)
                   for bad in tampered)
    assert not sp.verify_state_proof(t, k, res, b"\x00" * 32, hasher="poseidon", n_pages=N_PAGES)

    # the same proofs through the JAX package alone (its oracle's hashes)
    monkeypatch.undo()
    assert sp.hash_impl_by_name is not suite.hash_impl_by_name
    for (t, k), res in proofs:
        assert sp.verify_state_proof(t, k, res, commitment, hasher="poseidon", n_pages=N_PAGES)
    assert not sp.verify_state_proof(t, k, tampered[0], commitment, hasher="poseidon", n_pages=N_PAGES)
