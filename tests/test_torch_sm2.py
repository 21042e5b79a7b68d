"""Port SM2 verification and SM-suite admission (plain PyTorch) against the
JAX package at one 32-lane bucket, on valid lanes and every invalid kind;
the SM2 verify kernel's arithmetic built as host C++ (the kernel itself
runs only on the card, through chip_smoke.py); the kernel source's
constants and the port's SM2 tables pinned to the JAX ones.

The JAX side traces its SM2 program once for the whole file: every JAX call
here is at the [32, 16] shape of ``sm2._verify_xla`` (and SM3 at
[32, 32, 16])."""

import ctypes
import random
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import ec as jec
from fisco_bcos_tpu.ops import limb as jlimb
from fisco_bcos_tpu.ops import sm2 as jsm2
from fisco_bcos_tpu.ops import sm3 as jsm3
from fisco_bcos_tpu_torch import params
from fisco_bcos_tpu_torch.crypto import admission
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3 as ref_sm3
from fisco_bcos_tpu_torch.ops import _kernels, bigint, ec, limb, sm2

C = ref.SM2_CURVE
R = 1 << 256
KERNEL_SRC = _kernels.SOURCES["sm2_verify"]
BUCKET = 32


def _b(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _off_curve_y(x: int) -> int:
    y = 1
    while (y * y - (x**3 + C.a * x + C.b)) % C.p == 0:
        y += 1
    return y


def _cases():
    """(payload, r, s, (qx, qy)) rows: valid SM2 signatures over SM3(payload),
    then every invalid kind."""
    rows = []
    for i in range(8):
        d = 0x1234 + 7919 * i
        payload = b"sm2 port tx %d " % i + b"\xab" * (i * 29 % 130)
        r, s = ref.sm2_sign(ref_sm3(payload), d)
        rows.append((payload, r, s, ref.privkey_to_pubkey(C, d)))
    payload, r, s, pub = rows[0]
    qx, qy = pub
    rows += [
        (payload, 0, s, pub),  # r = 0
        (payload, C.n, s, pub),  # r = n
        (payload, r, 0, pub),  # s = 0
        (payload, r, C.n, pub),  # s = n
        (payload, r, C.n - r, pub),  # t = (r + s) mod n = 0
        (payload, r, s, (qx, _off_curve_y(qx))),  # Q off the curve
        (payload, r, s, (C.p + 3, qy)),  # qx >= p
        (payload, r, s, (qx, R - 1)),  # qy >= p
        (payload, r, s, (0, 0)),  # Q = (0, 0)
        (b"another payload", r, s, pub),  # wrong hash
        (payload, r, s ^ (1 << 9), pub),  # corrupted s
        (payload, r ^ (1 << 200), s, pub),  # corrupted r
        (payload, r, s, rows[1][3]),  # another signer's key
    ]
    return rows


def _sig128(rows) -> np.ndarray:
    return np.stack(
        [np.frombuffer(_b(r) + _b(s) + _b(q[0]) + _b(q[1]), dtype=np.uint8) for _, r, s, q in rows]
    )


def _edge_e_rows():
    """(e, r, s, pub) rows fed to verify_device directly: e = 0,
    e = 2^256 - 1, n and n - 1, which no SM3 digest reaches on purpose;
    valid and not."""
    return ref.sm2_edge_e_rows((0, R - 1, C.n, C.n - 1), 12, random.Random(0x5EED))


def _limbs_i32(vals) -> np.ndarray:
    return np.stack([bigint.int_to_limbs(v) for v in vals]).astype(np.int32)


def _edge_limbs(rows, pad_to: int) -> list[np.ndarray]:
    cols = [[e for e, *_ in rows], [r for _, r, _, _ in rows], [s for _, _, s, _ in rows]]
    cols += [[q[0] for *_, q in rows], [q[1] for *_, q in rows]]
    return [_limbs_i32(c + [0] * (pad_to - len(c))) for c in cols]


@pytest.fixture(scope="module")
def sm2_run():
    rows = _cases()
    assert len(rows) <= BUCKET
    payloads = [p for p, *_ in rows]
    sigs = _sig128(rows)
    hashes = np.stack([np.frombuffer(ref_sm3(p), dtype=np.uint8) for p in payloads])
    rs, ss, pubs = sigs[:, :32], sigs[:, 32:64], sigs[:, 64:]
    edge = _edge_e_rows()
    edge_limbs = _edge_limbs(edge, BUCKET)
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        # the plain versions must never reach the kernel loader
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        port["e"] = sm2.sm2_e_batch(hashes, pubs, device="cpu")
        port["verify"] = sm2.verify_batch(hashes, rs, ss, pubs, device="cpu")
        port["recover"] = sm2.recover_batch(hashes, sigs, device="cpu")
        port["admit"] = admission.admit_batch_sm(payloads, sigs, device="cpu")
        port["edge"] = sm2.verify_device(*(torch.from_numpy(a) for a in edge_limbs)).numpy()
    jax_out = {
        "e": np.asarray(jsm2.sm2_e_batch(hashes, pubs)),
        "verify": np.asarray(jsm2.verify_batch(hashes, rs, ss, pubs)),
        "edge": np.asarray(jsm2.verify_device(*(a.astype(np.uint32) for a in edge_limbs))),
    }
    # the JAX composition of txpool/validator.py:143-149 on the SM suite
    jh = np.asarray(jsm3.sm3_batch(payloads))
    jpubs, jok = (np.asarray(a) for a in jsm2.recover_batch(jh, sigs))
    jsenders = np.asarray(jsm3.sm3_batch([bytes(p) for p in jpubs]))[:, 12:]
    jax_out["recover"] = (jpubs, jok)
    jax_out["admit"] = (jsenders, jok, jpubs, jh)
    return rows, hashes, sigs, edge, edge_limbs, port, jax_out


def test_sm2_e_batch_matches_jax_and_reference(sm2_run):
    rows, hashes, _, _, _, port, jax_out = sm2_run
    np.testing.assert_array_equal(port["e"], jax_out["e"])
    for i, (_, _, _, pub) in enumerate(rows):
        assert int.from_bytes(bytes(port["e"][i]), "big") == ref.sm2_e(bytes(hashes[i]), pub), i


@pytest.mark.parametrize("id_len", [0, 1, 16, 53])
def test_sm2_e_batch_user_ids_match_jax_and_reference(sm2_run, id_len):
    """Non-default SM2 user IDs. Up to 53 bytes, ZA stays 4 SM3 blocks, so
    the JAX side runs at the shape the fixture already traced."""
    rows, hashes, sigs, _, _, _, _ = sm2_run
    user_id = bytes(random.Random(id_len).randrange(256) for _ in range(id_len))
    pubs = sigs[:, 64:]
    got = sm2.sm2_e_batch(hashes, pubs, user_id=user_id, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jsm2.sm2_e_batch(hashes, pubs, user_id=user_id)))
    for i in range(len(rows)):
        assert bytes(got[i]) == ref.sm2_e_bytes(bytes(pubs[i]), bytes(hashes[i]), user_id), i


@pytest.mark.parametrize("id_len", [None, 0, 1, 16, 53])
def test_e_form_cpu_entry_matches_jax(sm2_run, id_len, monkeypatch):
    """The e form's CPU entry, sm2.e_device on [32, 32] digests and [32, 16]
    key limbs (the 32-lane bucket, pad lanes zero), against the JAX
    sm2_e_batch on the same rows: the default ID and the pinned ones."""
    _, hashes, sigs, _, _, _, _ = sm2_run
    user_id = ref.SM2_DEFAULT_ID if id_len is None else bytes(
        random.Random(id_len).randrange(256) for _ in range(id_len)
    )
    pubs = np.zeros((BUCKET, 64), np.uint8)
    pubs[: len(sigs)] = sigs[:, 64:]
    h = np.zeros((BUCKET, 32), np.uint8)
    h[: len(hashes)] = hashes
    qx, qy = (torch.from_numpy(bigint.bytes_be_to_limbs(pubs[:, i : i + 32]).astype(np.int32)) for i in (0, 32))
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
    e = sm2.e_device(torch.from_numpy(h), qx, qy, user_id)
    assert e.dtype == torch.int32 and e.shape == (BUCKET, 16)
    want = np.asarray(jsm2.sm2_e_batch(h[: len(sigs)], pubs[: len(sigs)], user_id=user_id))
    np.testing.assert_array_equal(bigint.limbs_to_bytes_be(e.numpy())[: len(sigs)], want)


def test_verify_batch_matches_jax_and_reference(sm2_run):
    rows, hashes, _, _, _, port, jax_out = sm2_run
    np.testing.assert_array_equal(port["verify"], jax_out["verify"])
    want = [ref.sm2_verify(bytes(h), r, s, q) for h, (_, r, s, q) in zip(hashes, rows)]
    assert port["verify"].tolist() == want
    assert port["verify"][:8].all() and not port["verify"][8:].any()


def test_recover_batch_matches_jax(sm2_run):
    rows, _, sigs, _, _, port, jax_out = sm2_run
    pubs, ok = port["recover"]
    jpubs, jok = jax_out["recover"]
    np.testing.assert_array_equal(pubs, jpubs)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(pubs[ok], sigs[ok, 64:])
    assert not pubs[~ok].any()  # a not-ok lane's pubkey is zeroed


def test_verify_device_edge_digests_match_jax_and_reference(sm2_run):
    _, _, _, edge, _, port, jax_out = sm2_run
    np.testing.assert_array_equal(port["edge"], jax_out["edge"])
    want = [ref.sm2_verify_e(*row) for row in edge]
    assert port["edge"][: len(edge)].tolist() == want
    assert sum(want) == 4  # one valid lane per edge digest


def test_admit_batch_sm_matches_jax_composition(sm2_run):
    _, _, _, _, _, port, jax_out = sm2_run
    for name, got, want in zip(("senders", "ok", "pubkeys", "tx hashes"), port["admit"], jax_out["admit"]):
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_admit_batch_sm_matches_reference(sm2_run):
    rows, hashes, _, _, _, port, _ = sm2_run
    senders, ok, pubkeys, tx_hashes = port["admit"]
    assert senders.dtype == pubkeys.dtype == tx_hashes.dtype == np.uint8
    for j, (payload, r, s, q) in enumerate(rows):
        assert bytes(tx_hashes[j]) == ref_sm3(payload)
        assert ok[j] == ref.sm2_verify(ref_sm3(payload), r, s, q)
        pub = _b(q[0]) + _b(q[1]) if ok[j] else bytes(64)  # not-ok: the zero key ...
        assert bytes(pubkeys[j]) == pub
        assert bytes(senders[j]) == ref_sm3(pub)[12:]  # ... and its sender


def test_admit_batch_sm_empty_batch():
    senders, ok, pubkeys, hashes = admission.admit_batch_sm([], np.zeros((0, 128), np.uint8), device="cpu")
    assert senders.shape == (0, 20) and ok.shape == (0,)
    assert pubkeys.shape == (0, 64) and hashes.shape == (0, 32)


# ---------------------------------------------------------------------------
# The kernel source and the SM2 state
# ---------------------------------------------------------------------------


def _words_of(name: str, src: str) -> int:
    m = re.search(r"#define\s+%s\s*\{([^}]*)\}" % name, src)
    assert m, name
    words = [int(w.strip().rstrip("u"), 16) for w in m.group(1).replace("\\", "").split(",")]
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_kernel_source_constants():
    src = KERNEL_SRC.read_text()
    t = params.default_sm2_tables()
    b3 = 3 * C.b % C.p
    want = {
        "SM2_P": C.p,
        "SM2_N": C.n,
        "SM2_R1": t.r1,
        "SM2_R2": t.r2,
        "SM2_B_MONT": C.b * R % C.p,
        "SM2_B3_MONT": b3 * R % C.p,
    }
    for name, value in want.items():
        assert _words_of(name, src) == value, name
    assert t.r1 == R % C.p and t.r2 == R * R % C.p
    m = re.search(r"#define\s+SM2_PINV_NEG0\s+(0x[0-9A-Fa-f]+)u", src)
    assert int(m.group(1), 16) == t.mprime & 0xFFFFFFFF == (-pow(C.p, -1, 1 << 32)) % (1 << 32)
    assert C.a == C.p - 3  # the kernel's a·x = -(3x)


def test_sm2_tables_from_jax_equal_self_built():
    jax_tables = params.sm2_tables_from_jax(
        jec.g_comb_table(jec.SM2_OPS.name), jlimb.make_mont_field(C.p)
    )
    own = params.build_sm2_tables()
    assert jax_tables.same_as(own)
    np.testing.assert_array_equal(ec.g_comb_table("sm2"), jec.g_comb_table(jec.SM2_OPS.name))
    assert own.comb_words.shape == (30, 8) and own.comb_words.dtype == np.uint32
    F = limb.MontField(C.p, "cpu")
    for c in (1, 9, 15):  # row c-1 holds the Montgomery x of c·G, y 15 rows below
        x, y = ref.point_mul(C, c, (C.gx, C.gy))
        got = limb.rows_to_ints(own.comb_limbs()[[c - 1, 15 + c - 1]].T)
        assert got == [x * R % C.p, y * R % C.p]
        assert limb.rows_to_ints(F.to_plain(torch.from_numpy(own.comb_limbs()[[c - 1]].T.astype(np.int64)))) == [x]
    with pytest.raises(ValueError):
        params.sm2_tables_from_jax(np.zeros((60, 16), np.uint32), jlimb.make_mont_field(C.p))


def test_mont_field_matches_jax():
    rng = np.random.default_rng(19)
    plain = [0, 1, C.p - 1, R - 1] + [int.from_bytes(rng.bytes(32), "big") for _ in range(8)]
    F = limb.MontField(C.p, "cpu")
    JF = jec.SM2_OPS.F
    a = F.from_plain(limb.ints_to_rows(plain, "cpu"))
    b = torch.flip(a, dims=[1])
    got = {
        "enc": a, "mul": F.mul(a, b), "sqr": F.sqr(a), "add": F.add(a, b), "sub": F.sub(a, b),
        "neg": F.neg(a), "small": F.mul_small(a, 3), "plain": F.to_plain(a), "inv": F.inv(a),
    }
    jrows = np.stack([jlimb.int_to_rows(v) for v in plain], axis=1)

    def jax_ops(x):
        ja = JF.from_plain(x)
        jb = ja[:, ::-1]
        return {
            "enc": ja, "mul": JF.mul(ja, jb), "sqr": JF.sqr(ja), "add": JF.add(ja, jb),
            "sub": JF.sub(ja, jb), "neg": JF.neg(ja), "small": JF.mul_small(ja, 3),
            "plain": JF.to_plain(ja), "inv": JF.inv(ja),
        }

    want = jax.jit(jax_ops)(jrows)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]).astype(np.int64), err_msg=key)
    assert limb.rows_to_ints(got["plain"]) == [v % C.p for v in plain]


# ---------------------------------------------------------------------------
# The kernel's arithmetic, built as host C++
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The SM2 kernel source's arithmetic compiled as host C++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("sm2_host")
    shim = d / "shim.cpp"
    shim.write_text(
        f'#include "{KERNEL_SRC}"\n'
        'extern "C" void host_sm2_verify(const int32_t* e, const int32_t* r, const int32_t* s,\n'
        "    const int32_t* qx, const int32_t* qy, const uint32_t* comb, uint8_t* ok, int n) {\n"
        "  u32 slots[SLOT_WORDS];  // one lane's slots, stride 1\n"
        "  for (int i = 0; i < n; i++)\n"
        "    sm2_verify_lane(e + 16 * i, r + 16 * i, s + 16 * i, qx + 16 * i, qy + 16 * i,\n"
        "                    (const u32 (*)[8])comb, slots, 1, ok + i);\n"
        "}\n"
    )
    lib_path = d / "libsm2_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_sm2_verify.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    comb = np.ascontiguousarray(params.default_sm2_tables().comb_words)

    def run(e, r, s, qx, qy):
        limbs = [np.ascontiguousarray(a, dtype=np.int32) for a in (e, r, s, qx, qy)]
        ok = np.zeros(len(limbs[0]), np.uint8)
        lib.host_sm2_verify(*(a.ctypes.data for a in limbs), comb.ctypes.data, ok.ctypes.data, len(ok))
        return ok.astype(bool)

    return run


def test_kernel_arithmetic_on_host_matches_plain(sm2_run, host_kernel):
    _, _, sigs, _, edge_limbs, port, _ = sm2_run
    e = bigint.bytes_be_to_limbs(port["e"]).astype(np.int32)
    limbs = [bigint.bytes_be_to_limbs(sigs[:, 32 * k : 32 * k + 32]).astype(np.int32) for k in range(4)]
    np.testing.assert_array_equal(host_kernel(e, *limbs), port["verify"])
    np.testing.assert_array_equal(host_kernel(*edge_limbs), port["edge"])


def test_kernel_arithmetic_on_host_matches_reference(host_kernel):
    rng = np.random.default_rng(31)
    rows = []
    for i in range(48):
        d = int.from_bytes(rng.bytes(32), "big") % (C.n - 1) + 1
        pub = ref.privkey_to_pubkey(C, d)
        e = int.from_bytes(rng.bytes(32), "big")
        r, s = ref.sm2_sign_e(e, d, int.from_bytes(rng.bytes(32), "big") % (C.n - 1) + 1)
        if i % 4 == 1:
            e ^= 1 << int(rng.integers(256))  # a wrong digest
        elif i % 4 == 2:
            s = int.from_bytes(rng.bytes(32), "big") % C.n or 1  # another s
        rows.append((e, r, s, pub))
    ok = host_kernel(*_edge_limbs(rows, len(rows)))
    assert ok.tolist() == [ref.sm2_verify_e(*row) for row in rows]
    assert ok[0::4].all() and ok[3::4].all()
