"""Block QC validator — the sync-path signature-list check, batched on device.

Reference: bcos-pbft/core/BlockValidator.cpp:28-177 (asyncCheckBlock:
checkSealerListAndWeightList:80 then checkSignatureList:141-177 — a
*sequential* loop verifying every sealer signature on the header hash plus a
weight-quorum check; SURVEY.md marks it the #2 batch-verify hot loop). Here
the whole signature list is one device batch verify.
"""

from __future__ import annotations

import numpy as np

from ..crypto.suite import CryptoSuite
from ..ledger.ledger import ConsensusNode
from ..protocol.block_header import BlockHeader
from ..utils.log import get_logger
from .config import min_quorum

_log = get_logger("block-validator")


class BlockValidator:
    def __init__(self, suite: CryptoSuite):
        self.suite = suite

    def check_block(self, header: BlockHeader, nodes: list[ConsensusNode]) -> bool:
        """Validate a synced block's QC against the expected committee."""
        sealers = sorted(
            (n for n in nodes if n.node_type == "consensus_sealer"),
            key=lambda n: n.node_id,
        )
        if header.number == 0:
            return True
        # sealer list / weight list must match the committee exactly
        if header.sealer_list != [n.node_id for n in sealers]:
            _log.warning("block %d: sealer list mismatch", header.number)
            return False
        if header.consensus_weights != [n.weight for n in sealers]:
            _log.warning("block %d: weight list mismatch", header.number)
            return False
        if header.qc:
            return self._check_qc(header, sealers)
        if not header.signature_list:
            return False
        seen: set[int] = set()
        idxs: list[int] = []
        for s in header.signature_list:
            if s.index in seen or not 0 <= s.index < len(sealers):
                return False
            seen.add(s.index)
            idxs.append(s.index)

        sig_len = self.suite.signature_impl.sig_len
        if any(len(s.signature) != sig_len for s in header.signature_list):
            return False
        h = header.hash(self.suite)
        hashes = np.frombuffer(h * len(idxs), dtype=np.uint8).reshape(-1, 32)
        pubs = np.frombuffer(
            b"".join(sealers[i].node_id for i in idxs), dtype=np.uint8
        ).reshape(-1, 64)
        sigs = np.frombuffer(
            b"".join(s.signature for s in header.signature_list), dtype=np.uint8
        ).reshape(-1, sig_len)
        from ..device.plane import device_lane

        # QC checks gate block sync/commit: consensus lane of the plane
        with device_lane("consensus"):
            ok = self.suite.signature_impl.batch_verify(hashes, pubs, sigs)
        if not bool(np.asarray(ok).all()):
            _log.warning("block %d: QC signature verify failed", header.number)
            return False
        quorum = min_quorum(sum(n.weight for n in sealers))
        weight = sum(sealers[i].weight for i in idxs)
        if weight < quorum:
            _log.warning(
                "block %d: QC weight %d below quorum %d", header.number, weight, quorum
            )
            return False
        return True

    def qc_check_inputs(
        self, header: BlockHeader, nodes: list[ConsensusNode]
    ) -> tuple[tuple[bytes, ...], bytes, bytes] | None:
        """Everything :meth:`check_block` checks EXCEPT the pairing, for
        callers that fold many headers' pairings into one aggregate program
        (succinct header sync).

        Returns ``(signer qc_pubs, header hash, agg_sig)`` — the triple a
        BLS aggregate check consumes — when the header is aggregatable;
        ``None`` when it simply is not (genesis, signature-list headers,
        non-BLS QC schemes — the caller falls back to
        :meth:`check_block`); raises ``ValueError`` when a structural check
        FAILS outright (the header is definitively invalid, no fallback
        will save it)."""
        from .qc import QuorumCert

        if header.number == 0 or not header.qc:
            return None
        sealers = sorted(
            (n for n in nodes if n.node_type == "consensus_sealer"),
            key=lambda n: n.node_id,
        )
        if header.sealer_list != [n.node_id for n in sealers]:
            raise ValueError(f"block {header.number}: sealer list mismatch")
        if header.consensus_weights != [n.weight for n in sealers]:
            raise ValueError(f"block {header.number}: weight list mismatch")
        try:
            cert = QuorumCert.decode(header.qc)
        except ValueError as e:
            raise ValueError(
                f"block {header.number}: undecodable QC record: {e}"
            ) from None
        if cert.scheme != "bls":
            return None  # ed25519 certs have no shared pairing structure
        if cert.committee != len(sealers):
            raise ValueError(
                f"block {header.number}: QC committee size mismatch"
            )
        idxs = cert.signers()
        if not idxs:
            raise ValueError(f"block {header.number}: QC names no signers")
        if len(cert.agg_sig) != 96:
            raise ValueError(f"block {header.number}: malformed BLS agg sig")
        qc_pubs = [n.qc_pub for n in sealers]
        if any(not qc_pubs[i] for i in idxs):
            raise ValueError(
                f"block {header.number}: QC claims a signer with no "
                "registered qc_pub"
            )
        quorum = min_quorum(sum(n.weight for n in sealers))
        weight = sum(sealers[i].weight for i in idxs)
        if weight < quorum:
            raise ValueError(
                f"block {header.number}: QC weight {weight} below quorum "
                f"{quorum}"
            )
        return (
            tuple(qc_pubs[i] for i in idxs),
            header.hash(self.suite),
            cert.agg_sig,
        )

    def _check_qc(self, header: BlockHeader, sealers: list[ConsensusNode]) -> bool:
        """Aggregate-certificate header validation: ONE verification for
        the whole quorum instead of n per-sealer checks — block-sync and
        lightnode bandwidth/verify cost independent of committee size.
        A forged bitmap (claiming signers who never signed) fails the
        aggregate check; out-of-range/duplicate-free indexing is enforced
        by the bitmap representation itself."""
        from .qc import QuorumCert, verify_header_cert

        try:
            cert = QuorumCert.decode(header.qc)
        except ValueError as e:
            _log.warning("block %d: undecodable QC record: %s", header.number, e)
            return False
        if cert.committee != len(sealers):
            _log.warning("block %d: QC committee size mismatch", header.number)
            return False
        idxs = cert.signers()
        if not idxs:
            return False
        qc_pubs = [n.qc_pub for n in sealers]
        if any(not qc_pubs[i] for i in idxs):
            _log.warning(
                "block %d: QC claims a signer with no registered qc_pub",
                header.number,
            )
            return False
        quorum = min_quorum(sum(n.weight for n in sealers))
        weight = sum(sealers[i].weight for i in idxs)
        if weight < quorum:
            _log.warning(
                "block %d: QC weight %d below quorum %d",
                header.number, weight, quorum,
            )
            return False
        from ..device.plane import device_lane

        with device_lane("consensus"):
            if not verify_header_cert(cert, qc_pubs, header.hash(self.suite)):
                _log.warning(
                    "block %d: aggregate QC verification failed", header.number
                )
                return False
        return True
