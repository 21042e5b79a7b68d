"""The port's consensus codecs, quorum collector and block validator
(``fisco_bcos_tpu_torch/consensus``) against the JAX package's, on the CPU.

- **Codecs.** ``PBFTMessage``, ``ViewChangePayload``, ``NewViewPayload``,
  ``QuorumCert`` and the ``ConsensusStorage`` rows encode to the JAX bytes,
  and each package decodes the other's; ``vote_preimage``, ``qc_pub_for``,
  ``derive_qc_keypair`` and ``min_quorum`` give the JAX values.
- **Collector.** ``QuorumCollector.admit`` at 4 and at 7 members, in each
  scheme: at 4 a bad vote whose packet authenticates (struck,
  ``bad_qc_vote``); at 7 a demoted signer (its vote checked alone first)
  and, with Ed25519, that bad vote and a forged one whose packet does not
  authenticate (dropped, ``forged_qc_vote``); then the sealed
  certificate answered again. The engine's mixed-mode rescue
  (``PBFTEngine._verify_quorum_offlock``): two good QC votes, a bad one and a
  legacy vote, the aggregate failing and the QC votes checked one by one.
  The same ``(valid, bad, cert)``, collector counts, strikes and evidence
  as the JAX collector. The port's cases run together and its DevicePlane
  merges their aggregate checks into one batch (a plain Ed25519 batch costs
  ~3.5 s on the CPU whatever its lanes, a plain pairing check ~1.4 s).
- **Validator.** ``BlockValidator.check_block`` and ``qc_check_inputs`` on a
  signature-list header and a BLS QC header and on their tampered variants
  (a flipped signature, a bitmap naming a member who did not sign, a weight
  short of the quorum, a wrong sealer list): the JAX verdicts and the JAX
  ``ValueError`` cases. Every batch the port's validator sends rides the
  port plane's ``consensus`` lane.

The JAX side runs on its host legs (native signature loops, the host
pairing), so no JAX program is traced."""

from __future__ import annotations

import pytest
import torch

from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.ops import _kernels
from test_torch_consensus import (
    JAX,
    PORT,
    build_replica,
    clean_boards,
    concurrently,
    keys,
    merging_plane,
    recording_gateway,
    rows,
    schemes,
    suite_of,
)

H = bytes(range(32))


@pytest.fixture(autouse=True)
def no_kernel_loads(monkeypatch):
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))


def codec_values(pkg) -> dict:
    """Every codec of the consensus package on fixed values, as bytes."""
    suite = suite_of(pkg)
    m = pkg.messages
    out = {}
    msg = m.PBFTMessage(packet_type=m.PacketType.PREPARE, view=3, generated_from=2, number=7, proposal_hash=H,
                        proposal_data=b"a block", payload=b"a payload")
    msg.sign(suite, keys(pkg)[2])
    out["message"] = msg.encode()
    out["message_hash"] = msg.hash(suite)
    msg.qc_sig = b"\x5c" * 64
    out["message_qc"] = msg.encode()
    out["view_change"] = m.ViewChangePayload(5, 4, b"a prepared block", [b"p1", b"p22"]).encode()
    out["view_change_qc"] = m.ViewChangePayload(5, 4, b"a prepared block", [], b"a cert").encode()
    out["new_view"] = m.NewViewPayload([out["message"], out["message_qc"]]).encode()
    QC = pkg.qc.QuorumCert
    out["cert_ed25519"] = QC("ed25519", 7, QC.make_bitmap([0, 2, 6], 7), b"\x01" * 192).encode()
    out["cert_bls"] = QC("bls", 9, QC.make_bitmap([8, 1, 4], 9), b"\x02" * 96).encode()
    out["signers"] = QC.decode(out["cert_bls"]).signers()
    for what, raw in (("unknown scheme", b"\x07" + out["cert_bls"][1:]),
                      ("short bitmap", QC("bls", 9, b"\x01", b"").encode())):
        with pytest.raises(ValueError) as e:
            QC.decode(raw)
        out[what] = str(e.value)
    with pytest.raises(ValueError) as e:
        QC.make_bitmap([4], 4)
    out["bitmap outside"] = str(e.value)
    out["preimages"] = [pkg.qc.vote_preimage(suite, t, 3, 11, H) for t in m.PacketType]
    out["quorums"] = [pkg.config.min_quorum(w) for w in range(40)]
    out["qc_pubs"] = [pkg.qc.qc_pub_for(0xABC + i, name) for name in ("ed25519", "bls") for i in range(2)]
    out["qc_secrets"] = [pkg.qc.derive_qc_keypair(0xABC, name).secret for name in ("ed25519", "bls")]
    store = pkg.memory_storage.MemoryStorage()
    cs = pkg.storage.ConsensusStorage(store)
    cs.save_view(4)
    cs.save_vote(5, 1, H)
    cs.save_vote(6, 2, H[::-1])
    cs.save_prepared(6, 2, b"a prepared block", [b"p1", b"p22"])
    out["loaded"] = (cs.load_view(), cs.load_vote(5), cs.load_vote(6), cs.load_vote(9), cs.load_prepared())
    out["rows"] = rows(store)
    cs.prune_below(5)
    out["pruned_5"] = rows(store)
    cs.prune_below(6)
    out["pruned_6"] = (rows(store), cs.load_prepared(), cs.load_vote(6))
    return out


def test_codecs_equal_the_jax_bytes_both_ways():
    with schemes():
        port = codec_values(PORT)
    jax = codec_values(JAX)
    assert port == jax
    for name, raw in jax.items():
        if name in ("message", "message_qc"):
            for dec in (PORT, JAX):
                got = dec.messages.PBFTMessage.decode(raw)
                assert got.encode() == raw and got.hash(suite_of(dec)) == jax["message_hash"]
                assert got.verify(suite_of(dec), keys(dec)[2].pub)
    for pkg in (PORT, JAX):
        m = pkg.messages
        assert m.ViewChangePayload.decode(jax["view_change_qc"]).encode() == jax["view_change_qc"]
        assert m.ViewChangePayload.decode(jax["view_change"]).prepared_qc == b""
        assert m.NewViewPayload.decode(jax["new_view"]).encode() == jax["new_view"]
        assert pkg.qc.QuorumCert.decode(jax["cert_ed25519"]).encode() == jax["cert_ed25519"]


# ---------------------------------------------------------------------------
# The collector
# ---------------------------------------------------------------------------

BAD, FORGED, DEMOTED = 1, 3, 5


def collector_case(pkg, name: str, n: int):
    """The collector at `n` members in scheme `name`: returns a call that
    admits the quorum (twice: the second answer is the sealed certificate)
    and gives what it saw. At 7 a signer is demoted first."""
    qc = pkg.qc
    suite = suite_of(pkg)
    scheme = qc.get_scheme(name)
    kps = [scheme.derive_keypair(0xC0DE + 97 * n + i) for i in range(n)]
    pubs = [kp.pub for kp in kps]
    msg32 = qc.vote_preimage(suite, pkg.messages.PacketType.PREPARE, 0, 9, H)
    other = qc.vote_preimage(suite, pkg.messages.PacketType.PREPARE, 0, 9, H[::-1])
    # Ed25519 at 7 adds a forged vote to the bad one; BLS at 7 has none (an
    # aggregate that fails is isolated vote by vote, ~0.23 s a BLS vote)
    bad = {4: {BAD}, 7: {BAD, FORGED} if name == "ed25519" else set()}[n]
    votes = {i: scheme.sign_vote(kp, other if i in bad else msg32) for i, kp in enumerate(kps)}
    col = qc.QuorumCollector(suite, scheme)
    key = (int(pkg.messages.PacketType.PREPARE), 9, 0, H)
    for i, sig in votes.items():
        col.add_vote(key, i, sig)
    if n == 7:  # three strikes demote a signer: its vote is checked alone before the aggregate
        for _ in range(3):
            pkg.quota.get_quotas().note_invalid(qc.STRIKE_GROUP, col._strike_source(pubs[DEMOTED]), 1)

    def run():
        first = col.admit(key, msg32, None, pubs, lambda i: 1, pkg.config.min_quorum(n),
                          authenticated_fn=lambda i: i != FORGED)
        again = col.admit(key, msg32, None, pubs, lambda i: 1, pkg.config.min_quorum(n))
        return [(sorted(v), sorted(b), c.encode() if c is not None else None) for v, b, c in (first, again)], \
            col.stats(), n > DEMOTED and col.is_demoted(pubs[DEMOTED])

    return run


def rescue_case(pkg):
    """The engine's mixed-mode rescue: PREPAREs of a four-member committee
    with Ed25519 QC keys, two good QC votes (0, 2), a bad one (3) and a
    legacy vote with no qc_sig (1, authenticated on arrival)."""
    suite = suite_of(pkg)
    kps = keys(pkg)
    gw = recording_gateway(pkg, auto=True)
    rep = build_replica(pkg, kps[0], pkg.memory_storage.MemoryStorage(), gw)
    eng = rep.engine
    assert eng._qc_active()
    PT = pkg.messages.PacketType
    qc = pkg.qc
    pre = qc.vote_preimage(suite, PT.PREPARE, 0, 1, H)
    agreeing = {}
    for i, node in enumerate(rep.config.nodes):
        kp = next(k for k in kps if k.pub == node.node_id)
        m = pkg.messages.PBFTMessage(packet_type=PT.PREPARE, view=0, number=1, proposal_hash=H)
        m.generated_from = i
        m.sign(suite, kp)
        qkp = qc.derive_qc_keypair(kp.secret, "ed25519")
        if i == 1:
            m._authenticated = True
        else:
            m.qc_sig = eng.qc.scheme.sign_vote(qkp, pre if i != 3 else qc.vote_preimage(suite, PT.PREPARE, 0, 1, H[::-1]))
        agreeing[i] = m

    def run():
        ok, cert, bad = eng._verify_quorum_offlock(PT.PREPARE, 1, 0, H, agreeing)
        return (ok, cert, sorted(bad)), eng.qc.stats()

    return run


def strikes(pkg) -> dict:
    q = pkg.quota.get_quotas()
    return {g: {s: len(d) for s, d in st.strikes.items()} for g, st in q._groups.items()}, q.snapshot()


def evidence(pkg) -> list:
    return sorted(pkg.audit.EVIDENCE.snapshot(), key=lambda r: sorted(r.items()))


@pytest.mark.parametrize("name", ["ed25519", "bls"])
def test_collector_equals_the_jax_collector(name, monkeypatch):
    monkeypatch.setenv("FISCO_QC_SCHEME", name)
    monkeypatch.delenv("FISCO_QC", raising=False)
    for pkg in (JAX, PORT):  # a slow machine must not see a strike age out or a demotion lapse
        monkeypatch.setattr(pkg.quota.get_quotas(), "strike_window_s", 3600.0)
        monkeypatch.setattr(pkg.quota.get_quotas(), "demote_s", 3600.0)
    got = {}
    for pkg in (JAX, PORT):
        with clean_boards(), schemes(ed_impl=psuite.Ed25519Crypto(torch.device("cpu"))):
            cases = [collector_case(pkg, name, n) for n in (4, 7)]
            lanes = 4 + 7  # the first aggregate of each: every vote (the demoted one passed alone)
            if name == "ed25519":
                cases.append(rescue_case(pkg))
                lanes += 3  # the rescue's QC votes
            if pkg is PORT:
                items = lanes if name == "ed25519" else 2  # BLS: one pairing check a certificate
                with merging_plane(items) as plane:
                    results = concurrently(cases)
                assert plane.stats()["dispatches"] == 1
            else:
                results = [case() for case in cases]
            got[pkg.root] = (results, strikes(pkg), evidence(pkg))
    port, jax = got["fisco_bcos_tpu_torch"], got["fisco_bcos_tpu"]
    assert port == jax
    (four, s4, _), (seven, s7, demoted) = port[0][:2]
    assert four[0][:2] == ([0, 2, 3], [BAD]) and four[1][0] == [0, 2, 3]
    assert four[0][2] is not None and four[1][2] == four[0][2] and s4["fallbacks"] == 1
    assert demoted and seven[1][2] == seven[0][2] is not None
    kinds = sorted(r["kind"] for r in port[2])
    if name == "ed25519":
        assert seven[0][:2] == ([0, 2, 4, 5, 6], [BAD, FORGED]) and s7["fallbacks"] == 1 and s7["bad_votes"] == 2
        (ok, cert, bad), _ = port[0][2]
        assert (ok, cert, bad) == (True, None, [3])
        assert kinds == ["bad_qc_vote"] * 3 + ["forged_qc_vote"]
    else:
        assert seven[0][:2] == (list(range(7)), []) and s7["fallbacks"] == 0
        assert kinds == ["bad_qc_vote"]


# ---------------------------------------------------------------------------
# The validator
# ---------------------------------------------------------------------------


class LanePlane(plane_mod.DevicePlane):
    """A merging plane that keeps the lane of every request."""

    def __init__(self, items: int):
        super().__init__(window_ms=60_000, high_water=items, starvation_ms=60_000)
        self.lanes: list[tuple[str, str]] = []

    def submit(self, op, payload, n, exec_fn):
        self.lanes.append((op, plane_mod.current_lane()))
        return super().submit(op, payload, n, exec_fn)


def headers(pkg) -> tuple[list, dict]:
    """The committee and its headers: a signature-list one, a BLS QC one,
    and the tampered variants of each."""
    suite = suite_of(pkg)
    kps = sorted(keys(pkg), key=lambda kp: kp.pub)
    bls = pkg.qc.get_scheme("bls")
    qkps = [pkg.qc.derive_qc_keypair(kp.secret, "bls") for kp in kps]
    nodes = [pkg.ledger.ConsensusNode(kp.pub, weight=1, qc_pub=q.pub) for kp, q in zip(kps, qkps)]
    Header = pkg.block_header.BlockHeader

    def header(**kw):
        h = Header(version=1, number=5, parent_info=[pkg.block_header.ParentInfo(4, b"\x22" * 32)],
                   timestamp=1_700_000_000_005, sealer=1, sealer_list=[kp.pub for kp in kps],
                   consensus_weights=[1] * 4, txs_root=b"\x33" * 32, **kw)
        return h

    base = header()
    h = base.hash(suite)
    sig = {i: suite.signature_impl.sign(kps[i], h) for i in range(3)}
    Sig = pkg.block_header.SignatureTuple
    out = {"signatures": header(signature_list=[Sig(i, sig[i]) for i in range(3)])}
    flipped = bytearray(sig[1])
    flipped[40] ^= 1
    out["signatures, one flipped"] = header(signature_list=[Sig(0, sig[0]), Sig(1, bytes(flipped)), Sig(2, sig[2])])
    out["signatures, short weight"] = header(signature_list=[Sig(0, sig[0]), Sig(2, sig[2])])
    swapped = [kp.pub for kp in kps]
    swapped[0], swapped[1] = swapped[1], swapped[0]
    out["signatures, wrong sealer list"] = header(signature_list=[Sig(i, sig[i]) for i in range(3)])
    out["signatures, wrong sealer list"].sealer_list = swapped
    votes = {i: bls.sign_vote(qkps[i], h) for i in range(3)}
    cert = bls.build_cert(votes, 4)
    QC = pkg.qc.QuorumCert
    out["qc"] = header(qc=cert.encode())
    out["qc, forged bitmap"] = header(qc=QC("bls", 4, QC.make_bitmap([0, 1, 2, 3], 4), cert.agg_sig).encode())
    out["qc, short weight"] = header(qc=bls.build_cert({0: votes[0], 2: votes[2]}, 4).encode())
    out["qc, wrong sealer list"] = header(qc=cert.encode())
    out["qc, wrong sealer list"].sealer_list = swapped
    out["qc, undecodable"] = header(qc=b"\x02\x04")
    for hd in out.values():
        hd.clear_hash_cache()
    return nodes, out


def inputs_of(validator, header, nodes):
    try:
        return validator.qc_check_inputs(header, nodes)
    except ValueError as e:
        return f"ValueError: {e}"


def test_validator_verdicts_equal_the_jax_ones():
    got = {}
    with schemes() as _:
        for pkg in (JAX, PORT):
            nodes, hds = headers(pkg)
            validator = pkg.block_validator.BlockValidator(suite_of(pkg))
            inputs = {what: inputs_of(validator, hd, nodes) for what, hd in hds.items()}
            encoded = {what: hd.encode() for what, hd in hds.items()}
            if pkg is JAX:
                verdicts = {what: validator.check_block(hd, nodes) for what, hd in hds.items()}
                got["jax"] = (encoded, verdicts, inputs)
                continue
            verdicts, lanes = {}, []
            for kind, items in (("signatures", 3 + 3 + 2), ("qc", 2)):
                group = [w for w in hds if w.startswith(kind) and "wrong sealer" not in w and "undecodable" not in w
                         and not (kind == "qc" and "short" in w)]
                plane = LanePlane(items)
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(plane_mod, "_PLANE", plane)
                    ok = concurrently([lambda hd=hds[w]: validator.check_block(hd, nodes) for w in group])
                assert plane.stats()["dispatches"] == 1
                lanes += plane.lanes
                verdicts.update(zip(group, ok))
            for what, hd in hds.items():  # the rest fail before any batch
                if what not in verdicts:
                    plane = LanePlane(1)
                    with pytest.MonkeyPatch.context() as mp:
                        mp.setattr(plane_mod, "_PLANE", plane)
                        verdicts[what] = validator.check_block(hd, nodes)
                    assert not plane.lanes, what
            got["port"] = (encoded, {w: verdicts[w] for w in hds}, inputs)
    assert got["port"] == got["jax"]
    verdicts, inputs = got["port"][1], got["port"][2]
    assert {w for w, ok in verdicts.items() if ok} == {"signatures", "qc"}
    assert isinstance(inputs["qc"], tuple) and inputs["signatures"] is None
    assert inputs["qc, short weight"].startswith("ValueError") and inputs["qc, forged bitmap"][0] != inputs["qc"][0]
    assert {lane for _, lane in lanes} == {"consensus"}
    assert sorted(op for op, _ in lanes) == ["bls_aggregate_verify.cpu"] * 2 + ["verify.secp256k1.cpu"] * 3
