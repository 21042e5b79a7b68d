#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--parent DIR]

Needs one CUDA card, ``nvcc`` and the repo's ``fisco_bcos_tpu_torch`` package;
exits non-zero, printing no result, without them. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel from ``fisco_bcos_tpu_torch/csrc``, one ``nvcc`` per
   source, all started together (timed);
2b. the device observatory (``run_observatory_phase``), in two fresh
   interpreters. With the libraries just built: ``install_observatory()``,
   each host entry point once to load its libraries (the build ledger: one
   ``cache_hit`` a library with its load ms, no cold build), then once more
   on a clean ledger and trace: ``admit_batch`` at 10,240 lanes,
   ``secp256k1.verify_batch``, ``admit_batch_sm``, ``ed25519.verify_batch``,
   a ``merkle_root`` a hasher, a Poseidon ``hash_batch``, a BLS QC check and
   a two-header ``multi_pairing_verify``: one ``device.<op>`` span a call
   under its JAX op, each span's phases adding up to its wall, the
   ``admission`` span's execute at least the recover kernel's CUDA-event
   time (printed beside the verify span's and kernel's); 4 callers of a
   4-lane ``batch_verify`` merged through a plane (the queue phase under the
   plane op, the dispatch span over the ``device.secp256k1_verify`` span, a
   wait record a caller); live and peak CUDA bytes, the plane's stats; the
   overhead of the observatory, registry and tracer (on, off, off, on,
   median of 5 a turn) on ``admit_batch``, a 4-message ``hash_batch`` and a
   4-lane ``batch_verify``, and the ledger's bookkeeping µs a span. With an
   empty build directory: one ``keccak256_batch``, one cold ledger row under
   ``keccak256`` with nvcc's ms;
3. secp256k1 admission: on a 10,240-lane block with invalid lanes
   mixed in, holds the recover kernel against its plain PyTorch version on
   the card, bit for bit, one lane of every distinct case against the host
   oracle, and ``admit_batch``'s four outputs against the host oracle
   (reference keccak and reference ECDSA); runs ``admit_batch`` on a
   10,240-transaction block of valid transactions built as ``bench.py``'s
   admission benchmark builds them, with every launch counter set to 0 just
   before and read just after, and holds its outputs against the host
   oracle; times the kernel, its plain version, ``admit_batch``, each of its
   stages and the card's busy time in one profiled call;
4. secp256k1 verify: on a mixed and a timed 10,240-lane block,
   holds the verify kernel against its plain version on every lane and
   ``verify_batch`` against the host oracle; drives ``verify_batch`` on the
   timed block between the counters; times the kernel, its plain version,
   ``verify_batch`` and its stages (host_pad, upload, verify, download;
   with ``--parent``, the parent checkout's stages too, in turns);
5. SM2 / SM-suite admission: the same for the SM2 kernel and
   ``admit_batch_sm`` (SM3 tx hash, SM2 verify, SM3 sender), with lanes of
   digest e = 0 and e = 2^256 - 1 fed to ``sm2.verify_device`` directly;
   times the kernel, its plain version, ``sm2.verify_batch``,
   ``admit_batch_sm``, its stages and the card's busy time in one profiled
   call;
6. the hash kernels (keccak-256, SM3, SHA-256): the packed form of each
   held against its plain version and the host oracle (the port's
   ``crypto/ref`` hashes, hashlib for SHA-256) on every lane of a seeded
   mixed block of 4,096 messages of 0-700 bytes (every padding edge
   included), of ``[B, 64]`` and ``[B, 210]`` row
   blocks, of the mixed block with shuffled starts, with starts off 16-byte
   alignment and of a block whose warps' spans exceed the staging buffer
   (how many warps staged and how many read directly is printed), and of
   the 10,240 97-byte payloads, which also time each kernel, its plain
   version and its bound (SHA-256, which no admission path runs: the mixed
   block tiled to 10,240 lanes and a merkle level of 10,240 512-byte
   groups, each at 32, 4,224 and 10,240 lanes); each form held against its
   plain version on
   every lane: keccak's tx-hash form on the mixed block, the sender forms
   on the EC blocks' keys (zero keys and not-ok lanes included), SM3's e
   form on the SM2 mixed block for user IDs of 0, 1, 16, 53 and 300 bytes
   and the default; each form timed with its bound on its path's inputs;
   ``merkle_root`` of each hasher at 1, 16, 257, 4,097 and 10,240 leaves
   against a host oracle tree and the plain path, proofs of the 10,240-leaf
   tree, and its time and launches (one a level). Every path of phases 3-5
   runs with every plain version (hash, form, EC kernel) made to raise
   while it is counted, and its launches are checked kernel by kernel, none other
   allowed: ``admit_batch`` keccak256 2 (tx hash, sender) and
   secp256k1_recover 1, ``admit_batch_sm`` sm3 3 (packed tx hash, e,
   sender) and sm2_verify 1, ``sm2.verify_batch`` sm3 1 (e) and sm2_verify
   1, ``verify_batch`` secp256k1_verify 1; each profiled admission call
   prints the device kernels and copies its trace holds;
7. the CryptoSuite seam: ``ecdsa_suite()`` and ``sm_suite()`` built on the
   card and driven as the JAX node drives its suite. The three-call
   admission that ``batch_admit`` runs for a non-fused suite
   (``hash_batch`` -> ``batch_recover`` -> ``calculate_address_batch``) on
   the mixed and the timed blocks, counted: equal to ``admit_batch`` /
   ``admit_batch_sm`` and the host oracle on every lane, with the fused
   paths' launches a library (keccak256 2 + secp256k1_recover 1, the
   packed form in the tx-hash form's place; sm3 3 + sm2_verify 1), timed
   in turns with the fused path, with its stages and one profiled call;
   each suite's ``batch_verify`` and ``batch_recover`` on the first 4, 32,
   256 and 10,240 lanes of the mixed blocks, counted, equal to the ops
   entry points and the host oracle, and timed; ``merkle_root_async`` and
   ``merkle_tree`` through each suite over the 10,240 leaves of phase 6,
   equal to ``ops.merkle``'s root, levels and proofs;
8. Ed25519, the QC certificates' scheme: on a mixed 10,240-lane block of
   128 cases (tampered signatures, messages and keys; keys and R with
   y >= p, with x = 0 and the sign bit set, with no root; s >= L; the
   small-order and mixed-order keys and R that the cofactored equation
   accepts; the zero row; messages of 0-300 bytes with every SHA-512
   padding edge) and a timed block of 10,240 valid signatures of 32-byte
   messages from 64 seeded signers, holds the challenge kernel against its
   plain version and its rows against the host's hashlib rows
   (``device_inputs``) on every lane, and the verify kernel against its
   plain version and the host oracle on every lane, at 4, 7, 100 and
   10,240 lanes alone too; prints the verify kernel's blocks resident a SM;
   drives ``ed25519.verify_batch`` on the timed block between the counters
   (one launch of each kernel, every plain version and the host challenges
   made to raise) and times it, its stages (host_pad: the byte joins and
   the pack; upload; challenge; verify; download; with ``--parent``, the
   parent's kernels in the same composition, in turns), the verify kernel
   at 4, 7, 100 and 10,240 lanes and the challenge kernel at 4, 7, 32,
   4,224 and 10,240 (a call and alone, with its one-warp floor); with
   ``--parent``, the verify kernel in turns with the parent's, and
   ``verify_batch`` at 4, 7 and 10,240 lanes and the QC check
   (``Ed25519Crypto.batch_verify``) at 4 and 7 with the parent's challenge
   kernel in the path and with this one's, in turns; drives
   ``Ed25519Crypto`` on the card, as
   ``Ed25519QCScheme.verify_cert`` does, ``batch_verify`` and
   ``batch_recover`` at the same sizes, counted, equal to the ops entry
   point and the oracle, and timed. The suite and Ed25519 calls of phases
   7-8 ride the DevicePlane, the default path, and are timed in turns
   with their direct calls (``FISCO_DEVICE_PLANE=0``);
9. Poseidon, the succinct state plane's commitment hasher
   (``run_poseidon_phase``): the kernel on a mixed block of 4,096 seeded
   messages of 0-700 bytes (every 31/62-byte edge included) tiled to
   10,240 lanes, equal to its plain version on every lane (its first 32
   and 4,224 lanes, launched alone, the same) and to the host
   oracle (``crypto/ref/poseidon.py``, in worker processes) on the 4,096
   distinct messages, with shuffled starts and 5 bytes off alignment, and
   on a ``[4,096, 64]`` row block; the state commitment at the plane's
   defaults, driven through the port's Poseidon suite as
   ``StatePlane._bootstrap`` and ``preview`` drive theirs: 1,048,576
   DAG-transfer keys in 64 pages, one ``hash_batch`` of the key blobs and
   leaf preimages, a ``merkle_tree`` a page and the top tree (wall time;
   counted again: one launch for the leaves and one a tree level, no plain
   version), then one 10,240-transfer block's delta of 20,480 keys (wall
   time); sampled lanes of every level held against the plain version,
   one whole page tree, the top trees and sampled leaf messages against
   the oracle, and the delta's launches counted; the kernel timed (a call
   and alone) with its bound at 32, 4,224 and all lanes of the mixed
   block, of the delta's 40,960-message leaf batch and of a merkle level of
   10,240 512-byte groups; one page tree at the 17,408-leaf bucket, its
   wall time (direct and through the suite) and each level's kernel time
   beside its bound, and one 512-byte group alone (a message's latency);
10. BLS12-381, the aggregate-QC pairing check (``run_bls_phase``): on a
   mixed block of 11 seeded aggregate checks of an 8-member committee (a
   quorum, a single signer, the whole committee; an apk with a signer too
   many or too few, the wrong message, another quorum's signature, a
   malformed key, an empty signer set, a malformed signature, one outside
   the subgroup) tiled to 1,024 lanes, holds the pairing kernel against
   its plain version on the card (verdicts and GT elements, every lane)
   and against the host oracle (``crypto/ref/bls12_381.py``: verdicts and
   GT elements); drives ``BLSCrypto.aggregate_verify_batch``, the QC
   check's path, on the block between the counters (one launch, every
   plain version and the host pairing made to raise); times the kernel
   alone, ``pairing_check_batch``, the QC check (through the plane and
   direct, in turns) and the plain version at 1, 4, 64 and 1,024 lanes
   beside the bound and the oracle's host time for one check; with
   ``--parent``, the kernel at those lane counts and one
   ``BLSCrypto.aggregate_verify`` in turns with the parent's kernel; after
   the field bench, the one-warp latency floor of a check (its programs'
   rows at the bench's cycles a row) beside the kernel at one lane;
10b. BLS12-381's multi-pairing, header sync's one aggregate check
   (``run_multi_pairing_phase``): the multi-pairing kernel against the
   host oracle (verdicts and GT elements) on lists of 1, 2, 3, 9, 65 and
   129 pairs (one pair; a check's two, passing and failing; folds of two
   checks, accepted, rejected and with None pairs among them; a 64-header
   chunk, accepted and with one header's signature swapped; 8 and 128
   headers), and against its plain version on the card at 1, 2 and 65
   pairs, ``multi_pairing_check``'s
   verdicts the same; ``BLSCrypto.multi_pairing_verify`` of 64 headers of
   a seeded 8-member committee's quorum of 6, counted (one launch, every
   plain version and the host pairing made to raise), accepted, and
   rejected with one signature swapped; a list of only None pairs True with
   no launch; the kernel alone and ``multi_pairing_check`` at 2, 9, 65, 129
   and 257 pairs beside the bound; the chunk's stages (decode, hash_to_g2
   uncached and cached, the scalar multiplications, rows, upload, kernel)
   and the whole call in turns with ``aggregate_verify_batch`` of the same
   checks; after the field bench, its one-warp latency floor at each count;
11. the DevicePlane (``run_plane_phase``): every routed seam (the four
   hashes and their address forms, secp256k1 and SM2 verify and recover,
   Ed25519 verify, both admissions, each hasher's ``merkle_tree``) with
   callers of 1, 4, 7, 100 and 1,000 lanes of the mixed blocks released
   together, the first inside ``torch.cuda.stream`` of a stream of its
   own: one dispatch (``stats()``) making one call's launches, each
   caller's bytes equal to its own direct call's; a keccak-256, SM3 and
   SHA-256 caller alone on a stream of its own while the worker's stream sleeps before the
   launch, equal to the oracle (with a control copy that skips the event
   and reads stale bytes); a lone QC check (4 and 7 lanes), 4-lane
   secp256k1 ``batch_verify`` and 10,240-tx ``admit_batch`` direct and
   through the plane at windows of 0, 0.25, 0.5, 1 and 2 ms, in turns, and
   the lone QC check by segment (to enqueue, to dispatch and the lag past
   the window, the dispatch, to return) with this host's timed waits; 4,
   16 and 64 concurrent callers of 4-lane ``batch_verify`` on each curve
   and of 64-tx ``admit_batch``, serial direct against merged, in turns,
   with each caller's p50 and p99 and the dispatches; a QC check in the
   consensus lane and in the admission lane behind a 10,240-tx admission
   in flight and 64 small admissions queued, starvation off, then with a
   20 ms starvation rule that the small admissions pass: the dispatches'
   order and each queue's age at release;
11b. the multi-device fan-out (``run_sharding_phase``,
   ``parallel/sharding.py``): ``make_mesh()`` gives the cards and
   ``make_mesh(cards + 1)`` raises; each of the eight sharded programs
   (both admissions, secp256k1 verify, the QC check with seeded weights,
   SM2 and Ed25519 verify on the mixed 10,240-lane blocks, the XOR state
   root of 10,240 seeded digests, the merkle root of D·16^3 seeded leaves)
   at D = 1 on the real mesh and D = 2 and 4 on logical meshes that name
   the card 2 and 4 times (a stream a shard), counted (a shard's launches
   times D, no plain version), equal to its one-device call (the root to
   the one-device tree's padded root); ``admit_batch`` of the mixed block
   through the plane with ``FISCO_DEVICE_SHARD_MIN=0`` under the
   ``admission`` span (one card: no fan-out) and equal to the oracle;
   ``sharded_admission_packed`` at D = 1, 2, 4 in turns with the one-device
   body, from the same host arrays, with the allocator's cudaMalloc
   segments, at D = 2 and 4 also with every upload before the bodies (the
   order not taken) and with a fresh pool stream a shard a call
   (the streams not kept), and one profiled
   call at D = 4 in both orders and at D = 1 (the kernels' summed device
   time over their union, the recover kernels' start times); the thread's
   current device the same before and after. These are the fan-out's own
   costs on one card, not a multi-card speed;
11c. the node's transaction pool (``run_txpool_phase``, the port's
   ``txpool``, ``ledger``, ``storage`` and ``protocol``): BASELINE config
   4's flood at full width, 51,200 parallel-transfer transactions from
   ``bench.py``'s 64 admission signers in 5 batches of 10,240, each
   decoded from its wire bytes (signed with one ephemeral k a batch, a
   sample held against the host oracle's recovery), the last batch also
   carrying every rejected kind (a sixteenth of the signatures bad in six
   ways, intra-batch nonce repeats, a wrong chain and group, block limits
   expired and too far ahead); each batch through ``TxPool.submit_batch``
   on a four-node genesis, counted (one ``admit_batch``'s launches, no
   plain version), every lane's tx hash, status and sender as built, then
   sealed into a 10,240-tx block, its txs root and the overlay's state hash
   on the card (counted), ``Ledger.prewrite_block``, ``merge_into_prev``,
   ``on_block_committed``, each stage timed; a committed batch replayed:
   ``TX_ALREADY_IN_CHAIN`` on every lane, no launch; ``submit_batch`` into
   fresh pools (median of 5), its stages one at a time, ``admit_batch`` of
   the same transactions alone in turns with it, one profiled call; one
   SM batch through an SM pool and its block; every txs root, state hash
   and a sample of tx hashes against the host oracle in the oracle pool;
11d. PBFT consensus (``run_consensus_phase``, the port's ``consensus``,
   ``front``, ``resilience`` and ``observability.pipeline``): BASELINE
   config 4's committee (``bench.py bench_flood``'s keys), four replicas,
   each with its own ``Ledger`` over a ``MemoryStorage`` genesis, its own
   ``TxPool`` holding one 10,240-tx flood batch, a ``PBFTEngine`` with a
   ``ConsensusStorage``, a ``Sealer``, all over one ``InprocGateway``
   (inline dispatch, one host thread), the engines on the card. Execution
   ends at this script's ``StandIn`` (the proposal's header back, the block
   written through the ``Ledger``), which goes when the scheduler is
   ported. In each QC mode (Ed25519, BLS, ``FISCO_QC=0``) three rounds on
   fresh committees, the leader's seal to the stable commit on every
   replica, the first counted (the txs roots' and the quorum checks'
   kernels, no plain version), the median wall and the engine's ``pbft.*``
   spans; every stable header accepted by ``BlockValidator`` on the card,
   its QC record or signature list under the host oracle, four tampered
   variants rejected, the txs root equal to the host oracle's; one profiled
   round (device busy, kernels by name). ``QuorumCollector.admit`` and
   ``verify_header_cert`` at 64 members in each scheme with one bad vote,
   the struck member and the verdicts against the host oracle; the QC
   check at 4 and 64 members through the plane and direct, in turns. Last,
   a view change, with the card to itself (a packet that carries the block
   is hashed on the host wherever it is signed or checked, minutes of
   work): the block prepared by the next view's leader alone, every COMMIT
   dropped, all four time out, the new leader re-proposes the block with
   its transactions and the other three run ``batch_admit`` on the plane's
   ``consensus`` lane (counted), then ``batch_admit`` against
   ``admit_batch`` alone in turns;
12. with ``--parent DIR`` (another checkout, for example the parent commit
   unpacked by ``git archive``), builds that checkout's kernels and holds
   each kernel against its counterpart there on the timed blocks, each fed
   its own input layout (the verify kernel of a checkout before its
   byte-row redesign takes five limb tensors and the 60-row comb; each
   Poseidon kernel its own checkout's constants table, on the mixed block
   and the merkle level): equal
   on every lane, timed in turns parent, new, new, parent; a kernel the
   parent lacks is not timed against it (SHA-256 on its mixed block and
   merkle level at 32, 4,224 and 10,240 lanes, the challenge at 4, 7, 32,
   4,224 and 10,240, each kernel on fresh rows); and times both admission paths'
   stages as the parent composes them (its packed hash kernel and the
   torch ops around it) and as this checkout does, in turns parent, new,
   new, parent;
13. times each kernel at 32, 4,224 and 10,240 lanes of
   its timed block (one warp, one warp a SM, the block); splits the host
   time of a packed keccak call and of a 4-lane challenge call (with
   ``--parent``, beside the parent's wrappers); and, with
   ``csrc/field_bench.cu`` built
   against this checkout's sources (and the parent's, with ``--parent``),
   the cycles one warp spends on each field op and group-law op, on an
   inversion mod n (Fermat and safegcd divsteps), on Poseidon's GF(FR) ops,
   rounds and permutation and on an SM2 product as the loop body around it
   grows (``clock64()``), and a block of SHA-256 and SHA-512 in the
   kernels' form and in the forms they did not take (the whole unroll,
   passes of 8 or 16 rounds; a 700-byte message's lane through one route
   or both, warm and cold, one lane or a round lane and a schedule lane a
   message), the challenge's lane and pair and its reduction mod L, each
   beside the bound's count of instructions a block, and BLS12-381's Fp
   ops (the product in each form, sums, a row of 8, 16 or 32 products and
   of 32 sums over slots, the inversion by Fermat and by divsteps);
14. prints every figure beside the card's name and power limit, one JSON
   line describing every kernel, and last the JSON result line; the
   DevicePlane is drained first, so no request of any phase is left
   unanswered.

After each phase it prints ``[phase] <name>: <s>``, the command time it
took. After the build it prints each kernel's registers, stack and spills
(ptxas), its size in SASS instructions (``cuobjdump``) and its launch
geometry at the block's width.

No phase's failure is caught: any mismatch or error ends the script with a
traceback and a non-zero exit code.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

BLOCK_TXS = 10_240  # a 10k-tx block, bucketed as hash_common._bucket does
UNIQUE_SIGNERS = 128  # distinct cases of the mixed (correctness) block
BENCH_SIGNERS = 64  # distinct signers of the timed block, as in bench.py
SEED = 20_261_016

# H100 SXM: 32-bit integer multiply(-add) issues at 64 per clock per SM,
# half the fp32 FMA rate; the fp32 peak is 67 TFLOP/s counting an FMA as 2
# operations, so 67e12 / 2 / 2 integer multiplies per second.
INT32_MUL_PER_S = 67e12 / 4
HBM_BYTES_PER_S = 3.35e12

# 32-bit multiplies of the least work per operation of the kernels
# (csrc/secp256k1_common.cuh, csrc/sm2_verify.cu), each 32x32->64 product
# counted as two (low and high half): a 256-bit squaring needs 36 word
# products, not 64, and a product by a word that is 0 or 1 by construction
# is no work.
MULS_FP_MUL = 2 * (64 + 8 + 1)  # 8x8 words, fp_reduce_wide, fp_fold_top
MULS_FP_SQR = 2 * (36 + 8 + 1)
MULS_FP_SMALL = 2 * (8 + 1)  # fp_mul_small + fp_fold_top
MULS_FN_MUL = 2 * (64 + 32 + 20 + 4)  # 8x8 words + three folds by CN (CN[4] = 1)
MULS_FN_SQR = 2 * (36 + 32 + 20 + 4)
MULS_GLV = 2 * (2 * 80 + 4 * 16)  # two u2·g products; four c·basis, 4x4 words each
# verify's safegcd s^-1 mod n (csrc/secp256k1_modinv.cuh): 20 rounds, each
# t·(d, e) and t·(f, g), 4 x 9 signed word products apiece, n·(md, me) over
# n's 30-bit limbs other than 0 or a power of two (5), and the two md, me
# corrections (low halves only); the divsteps themselves are adds, masks
# and shifts
MULS_FN_INV_DIVSTEP = 20 * (2 * (4 * 9 + 2 * 5) + 2 + 2 * 4 * 9)
VERIFY_WINDOWS = 27  # verify's ladder: signed 5-bit digits in [-15, 16]
RECODE_OFFSET = 15 * (32**VERIFY_WINDOWS - 1) // 31  # 01111 in every window
# SM2's Montgomery product: only the a·b word products. The reduction needs
# no multiply: -p^-1 ≡ 1 mod 2^32 makes each step's m the low word itself,
# and p = 2^256 - 2^224 - 2^96 + 2^64 - 1 makes m·p shifts and subtracts.
# By a constant, only its words other than 0/1 count.
MULS_MM = 2 * 64
MULS_MM_SQR = 2 * 36
MULS_MM_R2 = 2 * 8 * 6  # R^2 mod p has 6 words other than 0/1
MULS_MM_R1 = 2 * 8 * 1  # R mod p (the table's Z = 1) has 1
# out of the Montgomery domain, a product by 1, is a reduction alone: no work

# The hash kernels (csrc/keccak256.cuh, csrc/sm3.cuh) have no multiply: their
# bound counts the 32-bit integer instructions a permutation or compression
# needs, a 3-input logic op (LOP3), a funnel shift or a 3-input add each as
# one, at the same 64 a clock a SM (INT32_MUL_PER_S).
# keccak-f[1600] on 32-bit lane halves, a round: the 5 column parities (2
# LOP3 a half), their rotations by 1 (2 shifts), each lane ^ c[x-1] ^
# rotl(c[x+1], 1) (a LOP3 a half), rho's 24 rotations (2 shifts), chi (a
# LOP3 a half), iota (2); and a block's 17 rate lanes absorbed.
KECCAK_ROUND_OPS = 5 * 2 * 2 + 5 * 2 + 25 * 2 + 24 * 2 + 25 * 2 + 2
KECCAK_F_OPS = 24 * KECCAK_ROUND_OPS + 17 * 2
# SM3, a round: a <<< 12; SS1 (a 3-input add, a rotation); SS2; FF; GG;
# W[j] ^ W[j+4]; TT1 and TT2 (two 3-input adds each); b <<< 9, f <<< 19; P0
# (two shifts, a LOP3). The schedule's 52 words, 7 each (P1's two shifts and
# LOP3, two more rotations and LOP3s). The chaining value's 8 XORs.
SM3_ROUND_OPS = 1 + 2 + 1 + 1 + 1 + 1 + 2 + 2 + 2 + 3
SM3_COMPRESS_OPS = 64 * SM3_ROUND_OPS + 52 * 7 + 8
# SHA-256, a round: Σ1 and Σ0 (three shifts and a LOP3 each); Ch and Maj (a
# LOP3 each); T1 (two 3-input adds of h, Σ1, Ch, K, W); e = d + T1; a = T1 +
# Σ0 + Maj. The schedule's 48 words, 10 each (σ0 and σ1: three shifts and a
# LOP3 each; two 3-input adds). The chaining value's 8 adds.
SHA256_ROUND_OPS = 4 + 1 + 2 + 4 + 1 + 1 + 1
SHA256_COMPRESS_OPS = 64 * SHA256_ROUND_OPS + 48 * 10 + 8

# BLS12-381's pairing check (csrc/bls12_381.cu), a lane. The bound counts
# the least work of the check, fixed here and not taken from the kernel: the
# operations of the aggregate check's chain (BLS_CHAIN: the double Miller
# loop over |x| = 0xd201000000010000, 64 bits with 6 set, so 63 doubling
# iterations and 5 addition ones, each for both pairs, the squarings shared;
# the easy part; the hard part as the oracle's chain, five powers by |x|),
# each at the fewest Fp products known for it (BLS_LEAST_FP):
# - an Fp12 product 18 Fp2 products (Karatsuba, 3 Fp products each); a
#   squaring outside the cyclotomic subgroup 2 Fp6 products; one inside it
#   (every squaring after the easy part) 9 Fp2 squarings (Granger-Scott,
#   eprint 2009/565), an Fp2 squaring 2 Fp products;
# - the doubling step with its line 3 Fp2 products, 6 Fp2 squarings and 4
#   Fp products by the G1 point's coordinates; the mixed addition step 11,
#   2 and 4; the product by a line (3 Fp2 coefficients) 13 Fp2 products
#   (Aranha et al., eprint 2010/526, sections 4-5);
# - the p-Frobenius 5 Fp2 products (its first constant is 1), the
#   p^2-Frobenius 5 Fp2-by-Fp products (its constants lie in Fp), the
#   p^6-Frobenius a conjugation: none;
# - the inversion: two Fp6 squarings (Chung-Hasan, 2 Fp2 products and 3
#   squarings each), the Fp6 inverse (3 Fp2 squarings, 9 products), the
#   Fp2 inverse (2 Fp squarings, 2 products), two Fp6 products, and one Fp
#   inversion, counted by safegcd (Bernstein-Yang: 1,101 divsteps for 381
#   bits, 37 rounds of 30) as verify's inversion is, over 13 limbs of 30
#   bits.
# Every iteration of the Miller loop counts whole, the first too (its
# squaring of 1 and first line, 75 products, under 0.4%). An Fp product
# counts at its full Montgomery cost: its 144 word products and REDC's 12
# rows of 12 by m, each counted as two (low and high half), and the 12 m =
# t0·(-p^-1) (low half only); a squaring's 78 word products in place of
# 144. Lazy reduction inside the tower's sums is not counted, as no kernel
# here counts it.
BLS_CHAIN = {
    "fp12_sqr": 63, "dbl": 2 * 63, "add": 2 * 5, "line": 2 * (63 + 5),  # the Miller loop
    "fp12_inv": 1, "fp12_mul": 2 + 5 * 5 + 7, "frob_p2": 2, "frob_p": 1, "conj": 4,  # the rest of the
    "cyclo_sqr": 5 * 63 + 2,  # final exponentiation: easy part, then the hard part's chain
}
BLS_LEAST_FP = {
    "fp12_sqr": 2 * 18, "dbl": 3 * 3 + 6 * 2 + 4, "add": 11 * 3 + 2 * 2 + 4, "line": 13 * 3,
    "fp12_inv": 2 * (2 * 3 + 3 * 2) + (3 * 2 + 9 * 3) + 4 + 2 * 18, "fp12_mul": 18 * 3,
    "frob_p2": 5 * 2, "frob_p": 5 * 3, "conj": 0, "cyclo_sqr": 9 * 2,
}
BLS_LEAST_PRODUCTS = sum(n * BLS_LEAST_FP[op] for op, n in BLS_CHAIN.items())
BLS_LEAST_SQUARINGS = 2  # the Fp2 inverse's; every other product has two operands
BLS_FP_INV_MULS = 37 * (2 * (4 * 13 + 2 * 13) + 2 + 2 * 4 * 13)
MULS_BLS_REDC = 2 * 12 * 12 + 12
MULS_BLS_MUL = 2 * 144 + MULS_BLS_REDC
MULS_BLS_SQR = 2 * 78 + MULS_BLS_REDC
BLS_PAIRING_MULS = ((BLS_LEAST_PRODUCTS - BLS_LEAST_SQUARINGS) * MULS_BLS_MUL
                    + BLS_LEAST_SQUARINGS * MULS_BLS_SQR + BLS_FP_INV_MULS)
# The Fp products the kernel's own method makes a lane, of which squarings
# (its host build counts them; tests/test_torch_bls12_381.py pins the count
# and the chain above against it): a figure of the work done, not the bound.
# The least's but for the tower inverse's two Fp6 squarings, taken as
# products (12 more), and the one product that brings the divsteps'
# inverse into the Montgomery domain.
BLS_FP_PRODUCTS = 18_819
BLS_FP_SQUARINGS = 16
BLS_FP_INV_PRODUCTS = 1  # the product that brings the divsteps' inverse into the Montgomery domain


def bls_multi_chain(k: int) -> dict[str, int]:
    """The least chain of a K-pair multi-pairing: BLS_CHAIN with its two
    pairs' steps and lines replaced by K pairs' (one squaring of a shared f
    a bit, each pair's 63 doubling steps, 5 addition steps and 68 lines),
    the same one final exponentiation; no product of separate f values."""
    return {**BLS_CHAIN, "dbl": 63 * k, "add": 5 * k, "line": 68 * k}


def bls_multi_least_products(k: int) -> int:
    return sum(n * BLS_LEAST_FP[op] for op, n in bls_multi_chain(k).items())


def bls_multi_muls(k: int) -> int:
    """The bound's multiplies for K pairs, priced as BLS_PAIRING_MULS."""
    return ((bls_multi_least_products(k) - BLS_LEAST_SQUARINGS) * MULS_BLS_MUL
            + BLS_LEAST_SQUARINGS * MULS_BLS_SQR + BLS_FP_INV_MULS)

# Each path's counted run, launches a kernel (a hash kernel's forms are
# kernels of their own; every kernel not named must make none): keccak256 2
# + secp256k1_recover 1; sm3 3 + sm2_verify 1; sm3 1 + sm2_verify 1
ADMIT_LAUNCHES = {"keccak256_tx_hash": 1, "keccak256_sender": 1, "secp256k1_recover": 1}
ADMIT_SM_LAUNCHES = {"sm3_packed": 1, "sm3_e": 1, "sm3_sender": 1, "sm2_verify": 1}
SM2_VERIFY_LAUNCHES = {"sm3_e": 1, "sm2_verify": 1}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> int:
    """The SM clock now (nvidia-smi, MHz): read right after a timed run,
    while the card still holds the clock it ran at."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return int(out.stdout.strip().splitlines()[0])


def one_warp_floor_ms(cycles: int, mhz: int) -> float:
    """What one warp can reach when the card is not full: the instructions
    of its longest message's blocks, at one issue a cycle and `mhz`."""
    return cycles / (mhz * 1e3)


# ---------------------------------------------------------------------------
# Inputs and host oracle
# ---------------------------------------------------------------------------


def make_cases(n_unique: int, seed: int):
    """Signed payloads from deterministic keys plus invalid variants.

    Returns a list of (payload, sig65 bytes, expected pubkey (x, y) or None);
    the expectation follows the device rules: v ∈ {0..3, 27, 28} only."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    C = ref.SECP256K1
    rng = random.Random(seed)
    cases = []
    for i in range(n_unique):
        payload = b"fisco-bcos tx %06d " % i + bytes(rng.randrange(256) for _ in range(rng.randrange(20, 260)))
        d = rng.randrange(1, C.n)
        h = keccak256(payload)
        r, s, v = ref.ecdsa_sign(h, d)
        variant = i % 16
        if variant == 1:
            v += 27
        elif variant == 2:
            v = (4, 29, 30)[(i // 16) % 3]
        elif variant == 3:
            r = 0
        elif variant == 4:
            s = (0, C.n, (1 << 256) - 1)[(i // 16) % 3]
        elif variant == 5:
            r, v = C.p - C.n + (i // 16) % 3, 2  # x = r + n >= p
        elif variant == 6:
            r = rng.randrange(1, C.n)  # some x have no square root
        elif variant == 7:
            r = (r ^ (1 << rng.randrange(256))) % (1 << 256)  # corrupted r
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])
        expected = ref.ecdsa_recover(h, r, s, v) if v in (0, 1, 2, 3, 27, 28) else None
        if variant == 0:
            assert expected == ref.privkey_to_pubkey(C, d)
        cases.append((payload, sig, expected))
    return cases


def make_bench_block(n_unique: int):
    """Valid signed transactions as bench.py's admission benchmark makes
    them: 97-byte parallel-transfer payloads (one keccak block each) from
    fixed keys. Returns cases as make_cases does."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    C = ref.SECP256K1
    cases = []
    for i in range(n_unique):
        payload = b"bench parallel-transfer tx %06d" % i + b"\xab" * 64
        d = 0xBEEF + 104729 * i
        r, s, v = ref.ecdsa_sign(keccak256(payload), d)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])
        cases.append((payload, sig, ref.privkey_to_pubkey(C, d)))
    return cases


def tile(cases, n: int):
    import numpy as np

    picked = [cases[i % len(cases)] for i in range(n)]
    payloads = [c[0] for c in picked]
    sigs65 = np.frombuffer(b"".join(c[1] for c in picked), dtype=np.uint8).reshape(n, 65)
    return payloads, sigs65, picked


def recover_inputs(payloads, sigs65, device):
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
    from fisco_bcos_tpu_torch.ops.bigint import bytes_be_to_limbs

    digests = {p: np.frombuffer(keccak256(p), dtype=np.uint8) for p in set(payloads)}
    hashes = np.stack([digests[p] for p in payloads])

    def limbs(a):
        return torch.from_numpy(bytes_be_to_limbs(a).astype(np.int32)).to(device)

    v = torch.from_numpy(sigs65[:, 64].astype(np.int32)).to(device)
    return limbs(hashes), limbs(sigs65[:, :32]), limbs(sigs65[:, 32:64]), v


def expected_admission(picked):
    """Host oracle of admit_batch for the tiled block: (senders, ok, pubs,
    hashes) as numpy arrays. A not-ok lane has a zero key and the sender of
    the zero key, as the device program defines it."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    memo = {}

    def row(case):
        payload, _sig, expected = case
        key = (payload, _sig)
        if key not in memo:
            if expected is None:
                pub = bytes(64)
            else:
                pub = expected[0].to_bytes(32, "big") + expected[1].to_bytes(32, "big")
            memo[key] = (keccak256(pub)[12:], expected is not None, pub, keccak256(payload))
        return memo[key]

    rows = [row(c) for c in picked]
    as_u8 = lambda k, w: np.frombuffer(b"".join(r[k] for r in rows), dtype=np.uint8).reshape(-1, w)  # noqa: E731
    return as_u8(0, 20), np.array([r[1] for r in rows]), as_u8(2, 64), as_u8(3, 32)


# ---------------------------------------------------------------------------
# Operation counts of the kernels for this run's inputs
# ---------------------------------------------------------------------------


def _pow_ops(e: int) -> tuple[int, int]:
    """(multiplications, squarings) of the kernel's f_pow for exponent e:
    a 14-product table, then 4 squarings and a product per 4-bit window
    after the first nonzero one."""
    wins = [(e >> (4 * i)) & 0xF for i in range(63, -1, -1)]
    first = next(i for i, c in enumerate(wins) if c)
    rest = wins[first + 1 :]
    return 14 + sum(1 for c in rest if c), 4 * len(rest)


def _ladder_ops(window_sets, n_windows: int, add_muls, dbl_ops) -> tuple[int, ...]:
    """Sum, over a windowed ladder run MSB first, of each step's operation
    counts (tuples added elementwise): per window 4 doublings (dbl_ops),
    then an addition (add_muls[k]) for each scalar k whose window is
    nonzero. Doublings of the still-identity accumulator and the first
    addition to it are no work and are not counted."""
    total = [0] * len(dbl_ops)
    started = False
    for i in range(n_windows - 1, -1, -1):
        if started:
            total = [t + 4 * d for t, d in zip(total, dbl_ops)]
        for k, ops in zip(window_sets, add_muls):
            if (k >> (4 * i)) & 0xF:
                if started:
                    total = [t + o for t, o in zip(total, ops)]
                started = True
    return tuple(total)


def _glv_scalars(u1: int, u2: int) -> tuple[int, int, int, int]:
    """The ladder's four scalars: |ka|, |kb| of the GLV split of u2 (floor
    Barrett rounding, as the kernels) and the 128-bit halves of u1."""
    from fisco_bcos_tpu_torch.ops.ec import glv_params

    P = glv_params()
    c1 = (u2 * P.g1) >> 448
    c2 = (u2 * P.g2) >> 448
    ka = abs(u2 - (c1 * P.a1 + c2 * P.a2))
    kb = abs(c1 * P.b1_abs - c2 * P.b2)
    return ka, kb, u1 & ((1 << 128) - 1), u1 >> 128


def _glv_ladder_ops(u1: int, u2: int) -> tuple[int, int, int]:
    """(fp_mul, fp_sqr, fp_mul_small) of glv_dual_mul for scalars u1, u2:
    the c·Q table (14 additions of Q, whose Z is 1, so each is a mixed
    addition, 11 products) and its β view (15 products), then the 33-window
    ladder over the GLV split of u2 and the 128-bit halves of u1."""
    ka, kb, lo, hi = _glv_scalars(u1, u2)
    # complete addition 12 products, mixed 11, each with 2 products by 21;
    # a doubling 6 products, 2 squarings, 1 product by 21
    fp_mul, fp_sqr, small = _ladder_ops(
        (ka, kb, lo, hi), 33, [(12, 0, 2), (12, 0, 2), (11, 0, 2), (11, 0, 2)], (6, 2, 1)
    )
    return fp_mul + 14 * 11 + 15, fp_sqr, small + 14 * 2


def signed5_digits(k: int) -> list[int]:
    """verify's recoding of k < 2^130: 27 digits in [-15, 16], LSB first,
    with sum d_i·32^i = k (window i of k + RECODE_OFFSET, less 15)."""
    kk = k + RECODE_OFFSET
    return [((kk >> (5 * i)) & 31) - 15 for i in range(VERIFY_WINDOWS)]


def _glv_ladder5_ops(u1: int, u2: int) -> tuple[int, int, int]:
    """(fp_mul, fp_sqr, fp_mul_small) of verify's glv_dual_mul5: the c·Q
    table (15 mixed additions) and its β view (16 products), then 27
    windows MSB first of 5 doublings and an addition for each scalar whose
    digit is not 0. Doublings of the still-identity accumulator and the
    first addition to it are no work and are not counted."""
    digits = [signed5_digits(k) for k in _glv_scalars(u1, u2)]
    adds = [(12, 0, 2), (12, 0, 2), (11, 0, 2), (11, 0, 2)]  # complete, complete, mixed, mixed
    total, started = [0, 0, 0], False
    for i in range(VERIFY_WINDOWS - 1, -1, -1):
        if started:
            total = [t + 5 * d for t, d in zip(total, (6, 2, 1))]
        for ds, ops in zip(digits, adds):
            if ds[i]:
                if started:
                    total = [t + o for t, o in zip(total, ops)]
                started = True
    fp_mul, fp_sqr, small = total
    return fp_mul + 15 * 11 + 16, fp_sqr, small + 15 * 2


def warp_additions(rows) -> tuple[float, float]:
    """Ladder additions a warp pays on a verify block of BLOCK_TXS lanes
    tiled from `rows`, averaged over its warps (a host count from the run's
    inputs): the (window, scalar) pairs where any of the warp's 32 lanes
    has a digit other than 0, for 33 windows of 4 bits (the parent's
    ladder) and for 27 signed 5-bit windows."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    C = ref.SECP256K1
    lanes = []
    for h, r, s, _ in rows:
        sinv = pow(s % C.n, -1, C.n) if s % C.n else 0
        z = int.from_bytes(h, "big")
        lanes.append(_glv_scalars(z % C.n * sinv % C.n, r % C.n * sinv % C.n))
    n_warps = BLOCK_TXS // 32
    four = five = 0
    for w in range(n_warps):
        warp = [lanes[(32 * w + i) % len(lanes)] for i in range(32)]
        four += sum(any((k[j] >> (4 * i)) & 15 for k in warp) for i in range(33) for j in range(4))
        digits = [[signed5_digits(x) for x in k] for k in warp]
        five += sum(any(d[j][i] for d in digits) for i in range(VERIFY_WINDOWS) for j in range(4))
    return four / n_warps, five / n_warps


def recover_multiplies(case_hash: bytes, sig65: bytes) -> int:
    """32-bit multiplies of the least work the recover kernel's method needs
    for one lane, following its control flow: early exit on invalid input
    or a non-residue, then 33 windows of 4 doublings plus an addition per
    nonzero window. Doublings of the still-identity accumulator and the
    first addition to it are no work and are not counted."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    C = ref.SECP256K1
    r = int.from_bytes(sig65[:32], "big")
    s = int.from_bytes(sig65[32:64], "big")
    v = sig65[64]
    z = int.from_bytes(case_hash, "big")
    if not (v <= 3 or v in (27, 28)):
        return 0
    v = v - 27 if v >= 27 else v
    if not (0 < r < C.n and 0 < s < C.n):
        return 0
    x = r + (C.n if v & 2 else 0)
    if x >= C.p:
        return 0
    sqrt_m, sqrt_s = _pow_ops((C.p + 1) // 4)
    fp_mul, fp_sqr = 1 + sqrt_m, 2 + sqrt_s  # x^2·x; x^2 and the y^2 check
    y2 = (x * x * x + 7) % C.p
    y = pow(y2, (C.p + 1) // 4, C.p)
    if y * y % C.p != y2:
        return fp_mul * MULS_FP_MUL + fp_sqr * MULS_FP_SQR
    fn_mul, fn_sqr = _pow_ops(C.n - 2)
    fn_mul += 2  # u1, u2
    rinv = pow(r, C.n - 2, C.n)
    u1 = (-(z % C.n) * rinv) % C.n
    u2 = s * rinv % C.n
    lm, ls, small = _glv_ladder_ops(u1, u2)
    fp_mul, fp_sqr = fp_mul + lm, fp_sqr + ls
    expected = ref.ecdsa_recover(case_hash, r, s, v)
    if expected is not None:
        inv_m, inv_s = _pow_ops(C.p - 2)
        fp_mul, fp_sqr = fp_mul + inv_m + 2, fp_sqr + inv_s
    return (
        fp_mul * MULS_FP_MUL + fp_sqr * MULS_FP_SQR + small * MULS_FP_SMALL
        + fn_mul * MULS_FN_MUL + fn_sqr * MULS_FN_SQR + MULS_GLV
    )


def verify_multiplies(z: int, r: int, s: int) -> int:
    """32-bit multiplies of the least work the secp256k1 verify kernel's
    method needs for one lane. Every lane runs the whole method: the curve
    check (2 squarings, 1 product), s^-1 by safegcd divsteps, u1 and u2,
    the GLV split, the signed 5-bit ladder, and the two products of the
    projective compare."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    C = ref.SECP256K1
    sinv = pow(s % C.n, -1, C.n) if s % C.n else 0
    lm, ls, small = _glv_ladder5_ops(z % C.n * sinv % C.n, r % C.n * sinv % C.n)
    fp_mul, fp_sqr = 1 + lm + 2, 2 + ls
    return (
        fp_mul * MULS_FP_MUL + fp_sqr * MULS_FP_SQR + small * MULS_FP_SMALL
        + 2 * MULS_FN_MUL + MULS_FN_INV_DIVSTEP + MULS_GLV
    )


def sm2_verify_multiplies(r: int, s: int) -> int:
    """32-bit multiplies of the least work the SM2 verify kernel's method
    needs for one lane: Q into the Montgomery domain (2 products by R^2),
    the curve check (2 squarings, 1 product; a·x by additions), the c·Q
    table (14 complete additions, each 14 products, one of them by Z = 1),
    the 64-window ladder over s (G comb, mixed additions of 13 products)
    and t = r + s mod n (Q table, complete additions of 14), doublings of 3
    squarings and 10 products, and the compare (k·Z, (k+n)·Z; X out of the
    Montgomery domain is a reduction alone)."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    C = ref.SM2_CURVE
    t = (r % C.n + s) % C.n
    mm, sqr = _ladder_ops((t, s), 64, [(14, 0), (13, 0)], (10, 3))
    mm += 1 + 14 * 13 + 2  # x^2·x; the table; k·Z and (k+n)·Z
    sqr += 2
    return mm * MULS_MM + sqr * MULS_MM_SQR + 2 * MULS_MM_R2 + 14 * MULS_MM_R1


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over `reps` of the mean CUDA-event time of `inner` launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(fn, reps: int = 3) -> float:
    """Median wall time of `reps` warm calls, each ending synchronised."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def check_outputs(got, want, what: str, entry: str = "admit_batch", against: str = "host oracle") -> None:
    import numpy as np

    for name, g, w in zip(("senders", "ok", "pubkeys", "tx hashes"), got, want):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{entry} {name} != {against} on the {what}")


def check_mixed_block(cases, device) -> int:
    """The block with invalid lanes: kernel == plain on every lane, one lane
    of every distinct case == host oracle, admit_batch == host oracle.
    Returns the kernel's largest difference from the plain version."""
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch
    from fisco_bcos_tpu_torch.ops import secp256k1
    from fisco_bcos_tpu_torch.ops.bigint import limbs_to_int

    payloads, sigs65, picked = tile(cases, BLOCK_TXS)
    kernel, err, _ = compare_and_time(
        secp256k1.recover_device, secp256k1.recover_plain, recover_inputs(payloads, sigs65, device),
        "secp256k1_recover", "mixed block",
    )
    qx, qy, ok = (t.cpu().numpy() for t in kernel)
    for i in range(len(cases)):  # one lane of every distinct case
        expected = picked[i][2]
        got = (limbs_to_int(qx[i]), limbs_to_int(qy[i])) if ok[i] else None
        if got != expected:
            raise AssertionError(f"recover kernel != host oracle on lane {i}: {got} vs {expected}")
        if not ok[i] and (qx[i].any() or qy[i].any()):
            raise AssertionError(f"not-ok lane {i} carries a nonzero key")
    out = admit_batch(payloads, sigs65)
    check_outputs(out, expected_admission(picked), "mixed block")
    log(f"mixed block, {BLOCK_TXS} lanes ({int(ok.sum())} ok): recover kernel == plain; "
        f"{len(cases)} distinct lanes == host oracle; admit_batch == host oracle")
    return err


@contextlib.contextmanager
def plain_versions_forbidden():
    """While open, every plain hash of the port, every plain form of a hash
    kernel and every plain EC version raises: a counted path run inside it
    shows that no plain version runs on a CUDA path."""
    from fisco_bcos_tpu_torch.ops import address, bls12_381, ed25519, keccak, poseidon, secp256k1, sha256, sm2, sm3

    def refuse(*_args, **_kwargs):
        raise AssertionError("a plain version ran on a CUDA path")

    names = ((keccak, "keccak256_packed_plain"), (keccak, "keccak256_lanes"),
             (keccak, "keccak256_tx_hash_plain"), (sm3, "sm3_packed_plain"), (sm3, "sm3_blocks"),
             (sha256, "sha256_packed_plain"), (sha256, "sha256_blocks"),
             (address, "sender_address_plain"), (address, "sm3_sender_address_plain"),
             (sm2, "e_plain"), (secp256k1, "recover_plain"), (secp256k1, "verify_plain"),
             (sm2, "verify_plain"), (ed25519, "verify_plain"), (ed25519, "verify_core"),
             (ed25519, "challenge_plain"), (ed25519, "sha512_words"), (ed25519, "challenges"),
             (poseidon, "poseidon_packed_plain"), (poseidon, "poseidon_blocks"), (poseidon, "permute_lanes"),
             (bls12_381, "pairing_check_plain"), (bls12_381, "pairing_gt_plain"),
             (bls12_381, "host_pairing_check_batch"), (bls12_381, "multi_pairing_plain"),
             (bls12_381, "multi_pairing_gt_plain"), (bls12_381, "host_multi_pairing_check"))
    saved = [getattr(mod, name) for mod, name in names]
    for mod, name in names:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        drain_plane()  # no dispatch of the run may see the plain versions back
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def drain_plane() -> None:
    """Wait until the DevicePlane holds no request and runs no dispatch."""
    from fisco_bcos_tpu_torch.device.plane import get_plane

    if not get_plane().drain(timeout=120):
        raise AssertionError("the DevicePlane did not drain within 120 s")


def counted_run(fn, expected: dict, what: str):
    """`fn()` with every launch counter set to 0 just before and read just
    after, no plain version allowed; each kernel of `expected` must have
    made exactly its launches, and every other kernel none. Returns (fn's
    result, the counts a kernel)."""
    from fisco_bcos_tpu_torch.ops import _kernels

    drain_plane()  # the worker launches: nothing earlier may still be counting
    _kernels.reset_launches()
    with plain_versions_forbidden():
        out = fn()
    launches = dict(_kernels.LAUNCHES)
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(f"kernel {name} launched {n} times on {what}, not {expected.get(name, 0)}")
    return out, launches


def show_launches(launches: dict) -> str:
    """The launches of a counted run, a library (every form of a hash
    kernel together) and then each kernel that ran."""
    from fisco_bcos_tpu_torch.ops import _kernels

    libs = {k: v for k, v in _kernels.library_launches(launches).items() if v}
    return f"{libs} ({ {k: v for k, v in launches.items() if v} })"


def run_main_path(block, device) -> tuple[dict, float]:
    """The main path: admit_batch on the 10,240-tx block on the default
    device, counted (counted_run: the tx hash and sender through the keccak
    kernel's tx-hash and sender forms, recovery through the recover kernel),
    its outputs held against the host oracle. Returns the launch counts and
    the median end-to-end ms of warm calls."""
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch

    payloads, sigs65, picked = tile(block, BLOCK_TXS)
    out, launches = counted_run(
        lambda: admit_batch(payloads, sigs65), ADMIT_LAUNCHES, "admit_batch"
    )
    check_outputs(out, expected_admission(picked), "main path's block")
    log(f"main path: admit_batch on {BLOCK_TXS} txs == host oracle ({int(out[1].sum())} ok); "
        f"launches {show_launches(launches)}")
    return launches, host_ms(lambda: admit_batch(payloads, sigs65), reps=5)


def measure_recover_kernel(block, device) -> dict:
    """The kernel on the main path's inputs: equal to the plain version,
    both timed, and the bound from these inputs' work."""
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
    from fisco_bcos_tpu_torch.ops import secp256k1

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    z, r, s, v = recover_inputs(payloads, sigs65, device)
    _, err, plain_ms = compare_and_time(
        secp256k1.recover_device, secp256k1.recover_plain, (z, r, s, v),
        "secp256k1_recover", "main path's block",
    )
    kernel_ms = cuda_ms(lambda: secp256k1.recover_device(z, r, s, v))

    per_case = [recover_multiplies(keccak256(c[0]), c[1]) for c in block]
    muls = sum(per_case[i % len(block)] for i in range(BLOCK_TXS))
    row = kernel_row(
        "secp256k1_recover", "fisco_bcos_tpu_torch/csrc/secp256k1_recover.cu",
        "fisco_bcos_tpu/ops/pallas_ec.py:63", kernel_ms, muls,
        io_bytes=BLOCK_TXS * (3 * 16 * 4 + 4) + 60 * 8 * 4 + BLOCK_TXS * (2 * 16 * 4 + 1),
    )
    row.update(max_abs_err=err, plain_ms=plain_ms)
    return row


def admission_stages(block, device, parent=None) -> dict[str, float]:
    """Median ms of each stage of admit_batch on the block, each stage run
    warm and ending synchronised (the stages of admission_core, in order).
    With `parent` (another checkout's kernels module from before the hash
    kernels' forms), the stages as that checkout composed them: its packed
    keccak kernel, the tx hash converted to limbs, the keys to byte rows
    for the sender, and the pack converting both back."""
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.ops import keccak, secp256k1
    from fisco_bcos_tpu_torch.ops.address import pubkey_rows, sender_address_device
    from fisco_bcos_tpu_torch.ops.bigint import bytes_be_to_limbs_device, limbs_to_bytes_device
    from fisco_bcos_tpu_torch.ops.hash_common import rows_as_packed

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    st: dict = {}

    def host_pad():
        st["host"] = admission.host_inputs(payloads, sigs65)

    def upload():
        st["dev"] = [torch.from_numpy(a).to(device) for a in st["host"]]

    def tx_hash():
        if parent is None:
            st["h"], st["z"] = keccak.keccak256_tx_hash(*st["dev"][:3])
        else:
            st["z"] = bytes_be_to_limbs_device(parent.keccak256_packed(*st["dev"][:3]))

    def recover():
        st["q"] = secp256k1.recover_device(st["z"], *st["dev"][3:])

    def address():
        qx, qy, _ = st["q"]
        if parent is None:
            st["addr"], st["pub"] = sender_address_device(qx, qy)
        else:
            st["addr"] = parent.keccak256_packed(*rows_as_packed(pubkey_rows(qx, qy)))[:, 12:]

    def pack_download():
        qx, qy, ok = st["q"]
        if parent is None:
            admission.pack_admission_device(st["addr"], ok, st["pub"], st["h"]).cpu()
        else:
            u8 = torch.uint8
            torch.cat([st["addr"], ok.to(u8)[:, None], pubkey_rows(qx, qy),
                       limbs_to_bytes_device(st["z"]).to(u8)], dim=1).cpu()

    stages = (host_pad, upload, tx_hash, recover, address, pack_download)
    return {fn.__name__: host_ms(fn, reps=3) for fn in stages}


def device_busy_ms(fn, tries: int = 3) -> tuple[float, float, int, int]:
    """(busy, wall, kernels, copies) of one warm call of `fn` under
    torch.profiler: busy ms is the union of the device-side event intervals
    of the trace (0.0 when the profiler records no device events), wall ms
    the host clock around the same call, profiler overhead included;
    kernels and copies (memcpy, memset) count the trace's device events.
    The profiler drops the device events of some traces, so `fn` is
    profiled `tries` times and the trace that holds the most is kept."""
    events, wall_ms = profiled_events(fn, tries)
    copies = sum(is_copy(e) for e in events)
    return union_us(events) / 1e3, wall_ms, len(events) - copies, copies


def profiled_events(fn, tries: int = 3) -> tuple[list, float]:
    """(device events, wall ms) of one warm call of `fn` under
    torch.profiler: of `tries` traces, the one that holds the most device
    events (see device_busy_ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the profiler's own buffer bookkeeping is not the program's work
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"]
        if best is None or len(events) > len(best[0]):
            best = events, wall_ms
    return best


def is_copy(event) -> bool:
    return event.name.startswith(("Memcpy", "Memset"))


def union_us(events) -> float:
    """µs of the union of the events' device intervals."""
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in events):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us


# ---------------------------------------------------------------------------
# secp256k1 verify
# ---------------------------------------------------------------------------


def make_verify_cases(n_unique: int, seed: int):
    """(hash, r, s, (qx, qy)) rows with one lane in 16 of each bad kind
    (r = 0, s = 0, s >= n, qx >= p, Q off the curve, Q = (0, 0), a wrong
    hash, a corrupted r) and one each of valid signatures over z = 0 and
    z = 2^256 - 1 (u1 = 0; z > n reduced once)."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    C = ref.SECP256K1
    rng = random.Random(seed)
    rows = []
    for i in range(n_unique):
        d = rng.randrange(1, C.n)
        pub = ref.privkey_to_pubkey(C, d)
        variant = i % 16
        h = {8: bytes(32), 9: b"\xff" * 32}.get(variant, keccak256(b"verify case %d" % i))
        r, s, _ = ref.ecdsa_sign(h, d)
        if variant == 1:
            r = 0
        elif variant == 2:
            s = 0
        elif variant == 3:
            s = (C.n, (1 << 256) - 1)[(i // 16) % 2]
        elif variant == 4:
            pub = (C.p + (i // 16) % 3, pub[1])
        elif variant == 5:
            pub = (pub[0], (pub[1] + 1) % C.p)
        elif variant == 6:
            pub = (0, 0)
        elif variant == 7:
            h = keccak256(b"not the signed message %d" % i)
        elif variant == 10:
            r = (r ^ (1 << rng.randrange(256))) % (1 << 256)
        rows.append((h, r, s, pub))
    return rows


def verify_rows_from_block(block):
    """The timed verify block: bench_admission's signers and payloads, each
    lane's tx hash, r, s and public key."""
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    return [
        (keccak256(payload), int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big"), pub)
        for payload, sig, pub in block
    ]


def verify_arrays(rows, n: int):
    """Tile rows to n lanes: (hashes, rs, ss [n, 32], pubs [n, 64]) uint8 and
    the host oracle's verdicts (ecdsa_verify per distinct row, tiled)."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    b = lambda v: v.to_bytes(32, "big")  # noqa: E731
    uniq = [
        (h, b(r), b(s), b(q[0]) + b(q[1]), ref.ecdsa_verify(h, r, s, q)) for h, r, s, q in rows
    ]
    picked = [uniq[i % len(uniq)] for i in range(n)]
    cols = [
        np.frombuffer(b"".join(c[k] for c in picked), dtype=np.uint8).reshape(n, -1)
        for k in range(4)
    ]
    return (*cols, np.array([c[4] for c in picked]))


def verify_row_tensor(hashes, rs, ss, pubs, device):
    """The verify kernel's input on the card: [n, 160] uint8 rows."""
    import torch

    from fisco_bcos_tpu_torch.ops import secp256k1

    return torch.from_numpy(secp256k1.verify_rows(hashes, rs, ss, pubs, len(hashes))).to(device)


def limb_tensors(device, *arrays):
    """[B, 32] big-endian byte arrays -> [B, 16] int32 limb tensors."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops.bigint import bytes_be_to_limbs

    return [torch.from_numpy(bytes_be_to_limbs(a).astype(np.int32)).to(device) for a in arrays]


def verify_limbs(hashes, rs, ss, pubs, device):
    """The verify kernel input of a checkout from before the byte rows: five
    [n, 16] int32 limb tensors."""
    return limb_tensors(device, hashes, rs, ss, pubs[:, :32], pubs[:, 32:])


def compare_and_time(kernel_fn, plain_fn, args, name: str, what: str):
    """A kernel and its plain version on the same card tensors, equal on
    every lane of every output; the plain call is the timed one
    (synchronised host clock). Returns (the kernel's outputs, the largest
    elementwise difference, plain ms)."""
    import torch

    got = kernel_fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain_fn(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    for a, b in pairs:
        if not torch.equal(a, b):
            bad = (a != b).reshape(len(a), -1).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"{name} kernel != plain on the {what}, lanes {bad}")
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in pairs)
    return got, err, plain_ms


def check_verify_block(rows, device, what: str) -> tuple[int, float]:
    """verify kernel == verify_plain on every lane of a 10,240-lane block;
    verify_batch == the host oracle. Returns (max difference, plain ms)."""
    import numpy as np

    from fisco_bcos_tpu_torch.ops import secp256k1

    *arrays, want = verify_arrays(rows, BLOCK_TXS)
    _, err, plain_ms = compare_and_time(
        secp256k1.verify_device, secp256k1.verify_plain, (verify_row_tensor(*arrays, device),),
        "secp256k1_verify", what,
    )
    got = secp256k1.verify_batch(*arrays)
    if not np.array_equal(got, want):
        raise AssertionError(f"verify_batch != host oracle on the {what}")
    log(f"{what}, {BLOCK_TXS} lanes ({int(want.sum())} valid): verify kernel == plain; "
        f"verify_batch == host oracle")
    return err, plain_ms


def run_verify_path(rows) -> tuple[int, float]:
    """The verify path: verify_batch on the timed block, launch counters
    zeroed just before and read just after. Returns (launches of the verify
    kernel, median end-to-end ms)."""
    import numpy as np

    from fisco_bcos_tpu_torch.ops import secp256k1

    *arrays, want = verify_arrays(rows, BLOCK_TXS)
    got, launches = counted_run(
        lambda: secp256k1.verify_batch(*arrays), {"secp256k1_verify": 1}, "verify_batch"
    )
    if not np.array_equal(got, want) or not got.all():
        raise AssertionError("verify_batch != host oracle on the timed block")
    log(f"verify path: verify_batch on {BLOCK_TXS} signatures == host oracle; "
        f"launches {show_launches(launches)}")
    return launches["secp256k1_verify"], host_ms(lambda: secp256k1.verify_batch(*arrays), reps=5)


def verify_stages(rows, device, parent=None) -> dict[str, float]:
    """Median ms of each stage of verify_batch on the block, each stage run
    warm and ending synchronised (verify_batch's own steps, in order). With
    `parent` (another checkout's kernels module), the stages as that
    checkout's verify_batch runs them, through its kernel: five limb splits
    and five uploads where the kernel takes limbs (before the byte rows)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops import secp256k1
    from fisco_bcos_tpu_torch.ops.bigint import bytes_be_to_limbs
    from fisco_bcos_tpu_torch.ops.hash_common import bucket_batch

    hashes, rs, ss, pubs, _ = verify_arrays(rows, BLOCK_TXS)
    bb = bucket_batch(BLOCK_TXS)
    limbs = parent is not None and takes_limbs(parent)
    st: dict = {}

    def host_pad():
        if not limbs:
            st["host"] = [secp256k1.verify_rows(hashes, rs, ss, pubs, bb)]
            return
        st["host"] = []
        for a in (hashes, rs, ss, pubs[:, :32], pubs[:, 32:]):  # limb_tensor's host half
            padded = np.zeros((bb, 16), dtype=np.int32)
            padded[: len(a)] = bytes_be_to_limbs(a)
            st["host"].append(padded)

    def upload():
        st["dev"] = [torch.from_numpy(a).to(device) for a in st["host"]]

    def verify():
        if parent is None:
            st["ok"] = secp256k1.verify_device(*st["dev"])
        else:
            comb = (secp256k1.comb_words if limbs else secp256k1.verify_comb_words)(device)
            st["ok"] = parent.secp256k1_verify(*st["dev"], comb)

    def download():
        st["ok"].cpu().numpy()

    stages = (host_pad, upload, verify, download)
    return {fn.__name__: host_ms(fn, reps=3) for fn in stages}


def measure_verify_kernel(rows, device) -> dict:
    from fisco_bcos_tpu_torch.ops import secp256k1

    *arrays, _ = verify_arrays(rows, BLOCK_TXS)
    rows_dev = verify_row_tensor(*arrays, device)
    kernel_ms = cuda_ms(lambda: secp256k1.verify_device(rows_dev))
    per_case = [verify_multiplies(int.from_bytes(h, "big"), r, s) for h, r, s, _ in rows]
    muls = sum(per_case[i % len(rows)] for i in range(BLOCK_TXS))
    return kernel_row(
        "secp256k1_verify", "fisco_bcos_tpu_torch/csrc/secp256k1_verify.cu",
        "fisco_bcos_tpu/ops/pallas_ec.py:78", kernel_ms, muls,
        io_bytes=BLOCK_TXS * (secp256k1.VERIFY_ROW_BYTES + 1) + 64 * 8 * 4,
    )


def kernel_row(name, source, replaces, kernel_ms, ops, io_bytes, ops_kind="int32 multiplies") -> dict:
    """A kernel's line: its time, and its bound from this run's inputs —
    the larger of its counted integer operations (`ops_kind`) over the
    issue rate and its bytes (each input read once, each output written
    once) over HBM's rate."""
    ops_ms = ops / INT32_MUL_PER_S * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "ms": kernel_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        # no single PyTorch call computes ECDSA recovery, ECDSA, SM2 or
        # Ed25519 verification, keccak-256, SM3, SHA-256 or Poseidon:
        # nothing to time beside the kernels
        "library_ms": None,
        "ops": ops,
        "ops_kind": ops_kind,
    }


# ---------------------------------------------------------------------------
# SM2 / SM-suite admission
# ---------------------------------------------------------------------------

SM2_EDGE_LANES = 64  # lanes of digest e = 0 and e = 2^256 - 1 (verify_device)


def make_sm2_cases(n_unique: int, seed: int):
    """(payload, r, s, (qx, qy), ok) rows: SM2 signatures over SM3(payload)
    with one lane in 16 of each bad kind (r = 0, s = n, t = (r + s) mod n
    = 0, Q off the curve, qx >= p, Q = (0, 0), a wrong hash, a corrupted s);
    ok is the host oracle's verdict."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3

    C = ref.SM2_CURVE
    rng = random.Random(seed)
    rows = []
    for i in range(n_unique):
        payload = b"fisco-bcos sm tx %06d " % i + bytes(rng.randrange(256) for _ in range(rng.randrange(20, 260)))
        d = rng.randrange(1, C.n - 1)
        pub = ref.privkey_to_pubkey(C, d)
        r, s = ref.sm2_sign(sm3(payload), d)
        variant = i % 16
        if variant == 1:
            r = 0
        elif variant == 2:
            s = C.n
        elif variant == 3:
            s = C.n - r
        elif variant == 4:
            pub = (pub[0], (pub[1] + 1) % C.p)
        elif variant == 5:
            pub = (C.p + (i // 16) % 3, pub[1])
        elif variant == 6:
            pub = (0, 0)
        elif variant == 7:
            payload = payload + b"!"  # signed hash != this payload's hash
        elif variant == 8:
            s = s ^ (1 << rng.randrange(256))
        rows.append((payload, r, s, pub, ref.sm2_verify(sm3(payload), r, s, pub)))
    return rows


def make_sm2_bench_block(n_unique: int):
    """Valid SM-suite transactions: bench.py bench_sm2's signers (secret
    0x1234 + 7919·i) signing bench_admission's 97-byte payloads over their
    SM3 hash."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3

    C = ref.SM2_CURVE
    rows = []
    for i in range(n_unique):
        payload = b"bench parallel-transfer tx %06d" % i + b"\xab" * 64
        d = 0x1234 + 7919 * i
        r, s = ref.sm2_sign(sm3(payload), d)
        rows.append((payload, r, s, ref.privkey_to_pubkey(C, d), True))
    return rows


def sm2_tile(rows, n: int):
    """(payloads, sigs128 [n, 128] uint8, picked rows) tiled to n lanes."""
    import numpy as np

    b = lambda v: v.to_bytes(32, "big")  # noqa: E731
    picked = [rows[i % len(rows)] for i in range(n)]
    sigs = b"".join(b(r) + b(s) + b(q[0]) + b(q[1]) for _, r, s, q, _ in picked)
    return [c[0] for c in picked], np.frombuffer(sigs, dtype=np.uint8).reshape(n, 128), picked


def expected_admission_sm(picked):
    """Host oracle of admit_batch_sm: (senders, ok, pubs, hashes); a not-ok
    lane has the zero key and the sender of the zero key."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3

    memo = {}

    def row(case):
        payload, r, s, q, ok = case
        key = (payload, r, s, q)
        if key not in memo:
            pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big") if ok else bytes(64)
            memo[key] = (sm3(pub)[12:], ok, pub, sm3(payload))
        return memo[key]

    rows = [row(c) for c in picked]
    as_u8 = lambda k, w: np.frombuffer(b"".join(r[k] for r in rows), dtype=np.uint8).reshape(-1, w)  # noqa: E731
    return as_u8(0, 20), np.array([r[1] for r in rows]), as_u8(2, 64), as_u8(3, 32)


def sm2_device_inputs(payloads, sigs128, device):
    """The SM2 kernel's inputs as the SM admission path builds them: (e, r,
    s, qx, qy) [B', 16] int32 on the card."""
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.ops import sm2, sm3

    data, starts, lengths, r, s, qx, qy = (
        torch.from_numpy(a).to(device) for a in admission.host_inputs_sm(payloads, sigs128)
    )
    e = sm2.e_device(sm3.sm3_packed(data, starts, lengths), qx, qy)
    return [e, r, s, qx, qy]


def sm2_edge_lanes(device):
    """Lanes fed to verify_device directly with digest e = 0 and
    e = 2^256 - 1, which no SM3 output reaches on purpose: signatures made
    for that e (valid), the same with s + 1, and with e flipped in bit 0.
    Returns (limb tensors [e, r, s, qx, qy], host oracle verdicts)."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    rows = ref.sm2_edge_e_rows((0, (1 << 256) - 1), SM2_EDGE_LANES, random.Random(SEED + 2))
    b = lambda v: np.frombuffer(v.to_bytes(32, "big"), dtype=np.uint8)  # noqa: E731
    cols = [np.stack([b(v) for v in col]) for col in zip(*[(e, r, s, q[0], q[1]) for e, r, s, q in rows])]
    return limb_tensors(device, *cols), np.array([ref.sm2_verify_e(*row) for row in rows])


def check_sm2_mixed_block(rows, device) -> tuple[int, float]:
    """SM2 kernel == plain on every lane of the mixed block plus the e-edge
    lanes (one call each), the edge lanes == their oracle, admit_batch_sm ==
    host oracle. Returns (max difference, plain ms)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.crypto.admission import admit_batch_sm
    from fisco_bcos_tpu_torch.ops import sm2

    payloads, sigs128, picked = sm2_tile(rows, BLOCK_TXS)
    edge, edge_want = sm2_edge_lanes(device)
    args = [torch.cat([a, b]) for a, b in zip(sm2_device_inputs(payloads, sigs128, device), edge)]
    _, err, plain_ms = compare_and_time(sm2.verify_device, sm2.verify_plain, args, "sm2_verify", "mixed block")
    edge_got = sm2.verify_device(*edge).cpu().numpy()
    if not np.array_equal(edge_got, edge_want):
        raise AssertionError("sm2 kernel != host oracle on the e = 0 / e = 2^256 - 1 lanes")
    out = admit_batch_sm(payloads, sigs128)
    check_outputs(out, expected_admission_sm(picked), "mixed block", "admit_batch_sm")
    log(f"SM2 mixed block, {BLOCK_TXS} lanes ({int(out[1].sum())} ok) + {SM2_EDGE_LANES} e-edge lanes "
        f"({int(edge_want.sum())} ok): sm2 kernel == plain; edge lanes == oracle; "
        f"admit_batch_sm == host oracle")
    return err, plain_ms


def run_sm_path(rows) -> tuple[dict, float]:
    """The SM admission path: admit_batch_sm on the timed block, counted
    (counted_run: the tx hash, e and the sender through the SM3 kernel's
    packed, e and sender forms, verification through the SM2 kernel),
    outputs against the host oracle. Returns (the launch counts, median
    ms)."""
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch_sm

    payloads, sigs128, picked = sm2_tile(rows, BLOCK_TXS)
    out, launches = counted_run(
        lambda: admit_batch_sm(payloads, sigs128), ADMIT_SM_LAUNCHES, "admit_batch_sm"
    )
    check_outputs(out, expected_admission_sm(picked), "timed block", "admit_batch_sm")
    log(f"SM admission path: admit_batch_sm on {BLOCK_TXS} txs == host oracle "
        f"({int(out[1].sum())} ok); launches {show_launches(launches)}")
    return launches, host_ms(lambda: admit_batch_sm(payloads, sigs128), reps=5)


def measure_sm2(rows, device, plain_ms: float, err: int) -> tuple[dict, float]:
    """The SM2 kernel on the SM path's inputs: its own time and bound, with
    the plain version's time and difference from the mixed block's
    comparison (check_sm2_mixed_block: 10,240 lanes and the e-edge lanes;
    the plain version's time does not depend on the lanes' values); and
    sm2.verify_batch end to end, every lane held against the host oracle."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3
    from fisco_bcos_tpu_torch.ops import sm2

    payloads, sigs128, _ = sm2_tile(rows, BLOCK_TXS)
    args = sm2_device_inputs(payloads, sigs128, device)
    kernel_ms = cuda_ms(lambda: sm2.verify_device(*args))
    per_case = [sm2_verify_multiplies(r, s) for _, r, s, _, _ in rows]
    muls = sum(per_case[i % len(rows)] for i in range(BLOCK_TXS))
    row = kernel_row(
        "sm2_verify", "fisco_bcos_tpu_torch/csrc/sm2_verify.cu",
        "fisco_bcos_tpu/ops/pallas_ec.py:163", kernel_ms, muls,
        io_bytes=BLOCK_TXS * (5 * 16 * 4 + 1) + 30 * 8 * 4,
    )
    row.update(max_abs_err=err, plain_ms=plain_ms)
    digests = {p: np.frombuffer(sm3(p), dtype=np.uint8) for p in set(payloads)}
    hashes = np.stack([digests[p] for p in payloads])
    verify_args = (hashes, sigs128[:, :32], sigs128[:, 32:64], sigs128[:, 64:])
    got, launches = counted_run(
        lambda: sm2.verify_batch(*verify_args), SM2_VERIFY_LAUNCHES, "sm2.verify_batch"
    )
    if not got.all():
        raise AssertionError("sm2.verify_batch rejected a valid signature of the timed block")
    log(f"sm2.verify_batch on {BLOCK_TXS} signatures == host oracle; launches {show_launches(launches)}")
    return row, host_ms(lambda: sm2.verify_batch(*verify_args), reps=5)


def sm_admission_stages(rows, device, parent=None) -> dict[str, float]:
    """Median ms of each stage of admit_batch_sm on the timed block, each
    run warm and ending synchronised (the stages of admission_sm_core).
    With `parent` (another checkout's kernels module from before the hash
    kernels' forms), the stages as that checkout composed them: its packed
    SM3 kernel for the tx hash, ZA and e (the ZA rows built on the card),
    the sender from zeroed keys' byte rows, and the pack converting back."""
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.ops import sm2, sm3
    from fisco_bcos_tpu_torch.ops.address import pubkey_rows, sm3_sender_address_device
    from fisco_bcos_tpu_torch.ops.bigint import bytes_be_to_limbs_device, limbs_to_bytes_device
    from fisco_bcos_tpu_torch.ops.hash_common import rows_as_packed

    payloads, sigs128, _ = sm2_tile(rows, BLOCK_TXS)
    st: dict = {}

    def host_pad():
        st["host"] = admission.host_inputs_sm(payloads, sigs128)

    def upload():
        st["dev"] = [torch.from_numpy(a).to(device) for a in st["host"]]

    def tx_hash():
        st["h"] = (parent or sm3).sm3_packed(*st["dev"][:3])

    def sm2_e():
        qx, qy = st["dev"][5:7]
        if parent is None:
            st["e"] = sm2.e_device(st["h"], qx, qy)
            return
        prefix = torch.tensor(list(sm2.za_prefix()), dtype=torch.uint8, device=device)
        za_rows = torch.cat([prefix.expand(BLOCK_TXS, -1), pubkey_rows(qx, qy)], dim=1)
        za = parent.sm3_packed(*rows_as_packed(za_rows))
        st["e"] = bytes_be_to_limbs_device(parent.sm3_packed(*rows_as_packed(torch.cat([za, st["h"]], dim=1))))

    def verify():
        st["ok"] = sm2.verify_device(st["e"], *st["dev"][3:])

    def address():
        qx, qy = st["dev"][5:7]
        if parent is None:
            st["addr"], st["pub"] = sm3_sender_address_device(qx, qy, st["ok"])
            return
        ok = st["ok"][:, None]
        st["q"] = [torch.where(ok, q, torch.zeros_like(q)) for q in (qx, qy)]
        st["addr"] = parent.sm3_packed(*rows_as_packed(pubkey_rows(*st["q"])))[:, 12:]

    def pack_download():
        if parent is None:
            admission.pack_admission_device(st["addr"], st["ok"], st["pub"], st["h"]).cpu()
        else:
            u8 = torch.uint8
            z = bytes_be_to_limbs_device(st["h"])
            torch.cat([st["addr"], st["ok"].to(u8)[:, None], pubkey_rows(*st["q"]),
                       limbs_to_bytes_device(z).to(u8)], dim=1).cpu()

    stages = (host_pad, upload, tx_hash, sm2_e, verify, address, pack_download)
    return {fn.__name__: host_ms(fn, reps=3) for fn in stages}


def kernel_device_ms(fn, reps: int = 20, tries: int = 3) -> tuple[float, int] | None:
    """The device time of one kernel launch of `fn`, without the launch:
    the median duration of the device events in a torch.profiler trace of
    `reps` warm calls, and how many events the trace holds (None when it
    holds none). The profiler drops the device events of some traces (see
    device_busy_ms), so up to `tries` traces are taken until one holds
    them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"]
        if spans:
            return statistics.median(spans) / 1e3, len(spans)
    return None


def show_device_ms(m: tuple[float, int] | None) -> str:
    return "not measured" if m is None else f"{m[0]:.4f} ms ({m[1]} events)"


def log_busy(card: str, what: str, fn) -> None:
    busy, wall, kernels, copies = device_busy_ms(fn)
    if busy > 0:
        log(f"[{card}] {what}, one profiled call: device busy {busy:.3f} ms of "
            f"{wall:.2f} ms wall (device idle share {1 - busy / wall:.3f}); the trace holds "
            f"{kernels} device kernels and {copies} copies")
    else:
        log(f"[{card}] {what} device busy: not measured (no device events in the trace)")


# ---------------------------------------------------------------------------
# Hash kernels and the merkle root
# ---------------------------------------------------------------------------

HASH_KERNELS = ("keccak256", "sm3", "sha256")
HASH_EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 120, 135, 136, 137, 271, 272, 512)
HASH_MIXED = 4096  # messages of the mixed hash block, 0-700 bytes
MERKLE_LEAVES = (1, 16, 257, 4097, BLOCK_TXS)


def hash_fns(name: str):
    """(kernel wrapper, plain version, host oracle, blocks a message of n
    bytes takes, operations a block, JAX function replaced) of a hash
    kernel's packed form."""
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
    from fisco_bcos_tpu_torch.crypto.ref.sha2 import sha256 as ref_sha256
    from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3 as ref_sm3
    from fisco_bcos_tpu_torch.ops import _kernels, keccak, sha256, sm3

    if name == "keccak256":
        return (_kernels.keccak256_packed, keccak.keccak256_packed_plain, keccak256,
                lambda n: n // 136 + 1, KECCAK_F_OPS, "fisco_bcos_tpu/ops/keccak.py:132")
    if name == "sha256":
        return (_kernels.sha256_packed, sha256.sha256_packed_plain, ref_sha256,
                lambda n: (n + 8) // 64 + 1, SHA256_COMPRESS_OPS, "fisco_bcos_tpu/ops/sha256.py:79")
    return (_kernels.sm3_packed, sm3.sm3_packed_plain, ref_sm3,
            lambda n: (n + 8) // 64 + 1, SM3_COMPRESS_OPS, "fisco_bcos_tpu/ops/sm3.py:92")


def hash_mixed_messages() -> list[bytes]:
    """The mixed hash block: every padding edge, then seeded lengths of
    0-700 bytes."""
    rng = random.Random(SEED + 4)
    lengths = list(HASH_EDGE_LENGTHS) + [rng.randrange(701) for _ in range(HASH_MIXED - len(HASH_EDGE_LENGTHS))]
    return [rng.randbytes(n) for n in lengths]


def check_hash_lanes(name: str, args, msgs, what: str, memo: dict | None = None) -> tuple[int, float]:
    """A hash kernel's packed form == its plain version == the host oracle
    on every lane of the packed batch `args` holding `msgs`; prints how
    many warps staged their messages and how many read them directly.
    `memo` keeps the oracle's digests across calls of one hash (layouts of
    the same messages hash each once). Returns (largest difference from the
    plain version, plain ms)."""
    import torch

    kernel, plain, oracle = hash_fns(name)[:3]
    routes = torch.zeros(2, dtype=torch.int32, device=args[0].device)
    got, err, plain_ms = compare_and_time(lambda *a: kernel(*a, routes=routes), plain, args, name, what)
    got = got.cpu().numpy()
    memo = {} if memo is None else memo
    for i, m in enumerate(msgs):
        if m not in memo:
            memo[m] = oracle(m)
        if bytes(got[i]) != memo[m]:
            raise AssertionError(f"{name} kernel != host oracle on the {what}, lane {i} ({len(m)} bytes)")
    staged, direct = routes.tolist()
    log(f"  {name} packed, {what}: {staged} warps staged through shared memory, {direct} read directly")
    return err, plain_ms


def packed_layouts(device) -> list[tuple]:
    """(what, packed args, messages) of the packed form's layouts: the
    mixed block as pack_messages lays it out, its messages in shuffled
    order (starts scattered through the buffer), the block 5 bytes off
    16-byte alignment, [B, 64] and [B, 210] row blocks, and 1,024 messages
    of 600-700 bytes (a warp's span past the staging buffer)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops.hash_common import rows_as_packed, upload_packed

    mixed = hash_mixed_messages()
    data, starts, lengths = upload_packed(mixed, device)
    order = torch.randperm(len(mixed), generator=torch.Generator().manual_seed(SEED)).to(device)
    shifted = torch.cat([torch.zeros(5, dtype=torch.uint8, device=device), data])
    gen = np.random.default_rng(SEED + 5)
    rows = {w: gen.integers(0, 256, (HASH_MIXED, w), dtype=np.uint8) for w in (64, 210)}
    rng = random.Random(SEED + 7)
    long_msgs = [rng.randbytes(rng.randrange(600, 701)) for _ in range(1024)]
    layouts = [
        ("mixed hash block", (data, starts, lengths), mixed),
        ("mixed block, shuffled starts", (data, starts[order].contiguous(), lengths[order].contiguous()),
         [mixed[i] for i in order.tolist()]),
        ("mixed block, starts 5 bytes off 16-byte alignment", (shifted, starts + 5, lengths), mixed),
    ]
    for w, r in rows.items():
        layouts.append((f"[{HASH_MIXED}, {w}] row block", rows_as_packed(torch.from_numpy(r).to(device)),
                        [bytes(x) for x in r]))
    layouts.append(("1,024 messages of 600-700 bytes", upload_packed(long_msgs, device), long_msgs))
    return layouts


def check_hash_kernels(device) -> dict[str, int]:
    """Each hash kernel's packed form on every layout of packed_layouts,
    the host oracle's digests of their distinct messages computed once in
    the oracle pool. Returns each kernel's largest difference from its plain
    version."""
    layouts = packed_layouts(device)
    distinct = list(dict.fromkeys(m for _, _, msgs in layouts for m in msgs))
    chunk = max(1, len(distinct) // (4 * ORACLE_WORKERS))
    with oracle_pool() as pool:
        digests = {name: pool.map(oracle_digests, [(name, distinct[i:i + chunk])
                                                   for i in range(0, len(distinct), chunk)])
                   for name in HASH_KERNELS}
        memos = {name: dict(zip(distinct, (d for part in parts for d in part))) for name, parts in digests.items()}
    errs = {}
    for name in HASH_KERNELS:
        errs[f"{name}_packed"] = max(check_hash_lanes(name, args, msgs, what, memos[name])[0]
                                     for what, args, msgs in layouts)
        log(f"{name}: packed kernel == plain == host oracle on the {', the '.join(w for w, _, _ in layouts)}")
    return errs


SM2_USER_IDS = (None, 0, 1, 16, 53, 300)  # None: the default ID


def sm2_user_id(n: int | None) -> bytes:
    from fisco_bcos_tpu_torch.crypto.ref.ecdsa import SM2_DEFAULT_ID

    return SM2_DEFAULT_ID if n is None else random.Random(SEED + n).randbytes(n)


def check_hash_forms(cases, sm_cases, device) -> dict[str, int]:
    """Each form of the hash kernels == its plain version on every lane:
    keccak's tx-hash form on the mixed hash block; the keccak sender form on
    the keys the recover kernel gives for the mixed admission block (the
    zero key on its not-ok lanes); the SM3 sender form and the e form on the
    SM2 mixed block's keys, with the SM2 kernel's ok bits (not-ok lanes
    zeroed) and, for e, the SM3 digests of its payloads and user IDs of
    0, 1, 16, 53 and 300 bytes and the default. Returns each form's largest
    difference from its plain version."""
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.ops import address, ed25519, keccak, secp256k1, sm2, sm3
    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    errs = {}
    args = upload_packed(hash_mixed_messages(), device)
    _, errs["keccak256_tx_hash"], _ = compare_and_time(
        keccak.keccak256_tx_hash, keccak.keccak256_tx_hash_plain, args, "keccak256_tx_hash", "mixed hash block"
    )
    payloads, sigs65, _ = tile(cases, BLOCK_TXS)
    qx, qy, ok = secp256k1.recover_device(*recover_inputs(payloads, sigs65, device))
    _, errs["keccak256_sender"], _ = compare_and_time(
        address.sender_address_device, address.sender_address_plain, (qx, qy), "keccak256_sender",
        f"recover mixed block's keys ({int((~ok).sum())} zero keys)",
    )
    payloads, sigs128, _ = sm2_tile(sm_cases, BLOCK_TXS)
    data, starts, lengths, r, s, qx, qy = (
        torch.from_numpy(a).to(device) for a in admission.host_inputs_sm(payloads, sigs128)
    )
    h = sm3.sm3_packed(data, starts, lengths)
    ok = sm2.verify_device(sm2.e_device(h, qx, qy), r, s, qx, qy)
    _, errs["sm3_sender"], _ = compare_and_time(
        address.sm3_sender_address_device, address.sm3_sender_address_plain, (qx, qy, ok), "sm3_sender",
        f"SM2 mixed block's keys ({int((~ok).sum())} not-ok lanes)",
    )
    errs["sm3_e"] = 0
    for n in SM2_USER_IDS:
        uid = sm2_user_id(n)
        _, err, _ = compare_and_time(
            lambda *a: sm2.e_device(*a, user_id=uid), lambda *a: sm2.e_plain(*a, user_id=uid),
            (h, qx, qy), "sm3_e", f"SM2 mixed block, user ID of {len(uid)} bytes",
        )
        errs["sm3_e"] = max(errs["sm3_e"], err)
    log(f"hash forms == plain on every lane: keccak256_tx_hash on the mixed hash block, keccak256_sender "
        f"on the recover mixed block's keys, sm3_sender and sm3_e on the SM2 mixed block's keys "
        f"(e for user IDs of {', '.join(str(len(sm2_user_id(n))) for n in SM2_USER_IDS)} bytes)")
    return errs


def measure_hash_kernel(name: str, payloads, device) -> dict:
    """A hash kernel's packed form on a path's payloads (the 10,240
    97-byte tx payloads): equal to its plain version and the host oracle on
    every lane, both timed, and its bound from these messages' blocks."""
    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    kernel, _, _, blocks, block_ops, replaces = hash_fns(name)
    args = upload_packed(payloads, device)
    err, plain_ms = check_hash_lanes(name, args, payloads, "timed payload block")
    n_bytes = sum(len(p) for p in payloads)
    row = kernel_row(
        f"{name}_packed", f"fisco_bcos_tpu_torch/csrc/{name}.cu", replaces, cuda_ms(lambda: kernel(*args)),
        sum(blocks(len(p)) for p in payloads) * block_ops,
        io_bytes=n_bytes + len(payloads) * (8 + 4 + 32), ops_kind="int32 instructions",
    )
    row.update(max_abs_err=err, plain_ms=plain_ms, device_ms=kernel_device_ms(lambda: kernel(*args)))
    return row


def sha256_timed_blocks(device) -> dict:
    """SHA-256's timed blocks of 10,240 lanes, what its callers hash: the
    mixed hash block tiled (hash_batch's messages of 0-700 bytes), and a
    merkle level of 10,240 groups of 16 seeded nodes (512-byte messages).
    Each is (packed args on the card, the messages)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    mixed = hash_mixed_messages()
    tiled = [mixed[i % len(mixed)] for i in range(BLOCK_TXS)]
    nodes = np.random.default_rng(SEED + 8).integers(0, 256, (BLOCK_TXS * 16, 32), dtype=np.uint8)
    first = torch.arange(0, BLOCK_TXS * 16, 16, device=device)
    level = (torch.from_numpy(nodes).to(device).reshape(-1), first * 32,
             torch.full((BLOCK_TXS,), 512, dtype=torch.int32, device=device))
    groups = [nodes[16 * g : 16 * g + 16].tobytes() for g in range(BLOCK_TXS)]
    return {"mixed": (upload_packed(tiled, device), tiled), "merkle level": (level, groups)}


def measure_sha256(card: str, device, launches: int) -> dict:
    """The SHA-256 kernel on each of sha256_timed_blocks: == its plain
    version == hashlib on every lane; a call (CUDA events) and the kernel
    alone (profiler) at 32, 4,224 and 10,240 lanes, each beside its bound
    from those messages' compressions and its one-warp floor (the longest
    message's compressions at one issue a cycle, at the SM clock read after
    the timing); then merkle_root over 10,240 leaves and each of its
    levels' launches, a call and alone. Returns the mixed block's row at
    10,240 lanes, with `launches` (its path's: the merkle root)."""
    kernel, _, _, blocks, block_ops, replaces = hash_fns("sha256")
    rows = {}
    for what, (args, msgs) in sha256_timed_blocks(device).items():
        err, plain_ms = check_hash_lanes("sha256", args, msgs, f"{what} block, {BLOCK_TXS:,} lanes")
        shown = []
        for n in (32, 132 * 32, BLOCK_TXS):
            part = (args[0], args[1][:n], args[2][:n])
            row = kernel_row(
                "sha256_packed", "fisco_bcos_tpu_torch/csrc/sha256.cu", replaces, cuda_ms(lambda: kernel(*part)),
                sum(blocks(len(m)) for m in msgs[:n]) * block_ops,
                io_bytes=sum(len(m) for m in msgs[:n]) + n * (8 + 4 + 32), ops_kind="int32 instructions",
            )
            row.update(max_abs_err=err, plain_ms=plain_ms, launches=launches,
                       device_ms=kernel_device_ms(lambda: kernel(*part)))
            shown.append((n, row, max(blocks(len(m)) for m in msgs[:n]) * block_ops))
        mhz = sm_clock_mhz()  # once, after the timings: nvidia-smi between them lets the clock fall
        log(f"[{card}] sha256_packed on the {what} block: " + "; ".join(
            f"{n:,}: call {row['ms']:.4f} ms, alone {show_device_ms(row['device_ms'])}, bound "
            f"{row['bound_ms']:.4f} ms ({row['ops']} instructions), one-warp floor "
            f"{one_warp_floor_ms(cycles, mhz):.4f} ms" for n, row, cycles in shown)
            + f" (floors at {mhz} MHz); plain {plain_ms:.1f} ms at {BLOCK_TXS:,}")
        rows[what] = row
    measure_sha256_root(card, device)
    return rows["mixed"]


def measure_sha256_root(card: str, device) -> None:
    """merkle_root with hasher "sha256" over 10,240 seeded leaves on the
    card (host clock, synchronised) and each of its levels' launches: a call
    (CUDA events) and alone (profiler), with the level's groups."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels, merkle

    leaves = torch.from_numpy(np.random.default_rng(SEED + 9).integers(0, 256, (BLOCK_TXS, 32), dtype=np.uint8))
    on_card = leaves.to(device)
    root_ms = host_ms(lambda: merkle.merkle_root(on_card, hasher="sha256"), reps=5)
    padded, _ = merkle._padded_leaves(on_card, 16, device)
    levels = merkle._device_levels(padded, 16, "sha256")
    shown = []
    for cur in levels[:-1]:
        # the level's packed arguments as merkle._level makes them, so that
        # the profiler sees the kernel alone
        first = torch.arange(0, cur.shape[0], 16, device=device)
        args = (cur.reshape(-1), first * 32, ((cur.shape[0] - first).clamp(max=16) * 32).to(torch.int32))
        if not torch.equal(_kernels.sha256_packed(*args), merkle._level(cur, 16, _kernels.sha256_packed)):
            raise AssertionError("sha256 merkle level != merkle._level")
        ms = cuda_ms(lambda args=args: _kernels.sha256_packed(*args))
        alone = kernel_device_ms(lambda args=args: _kernels.sha256_packed(*args))
        shown.append(f"{first.shape[0]:,} groups: call {ms:.4f} ms, alone {show_device_ms(alone)}")
    log(f"[{card}] merkle_root (sha256) over {BLOCK_TXS:,} leaves on the card: {root_ms:.3f} ms; its "
        f"{len(levels) - 1} levels: " + "; ".join(shown))


def form_inputs(block, sm_block, device) -> dict:
    """Each form's wrapper arguments on its path's timed block: the tx
    payloads; the recover kernel's keys; the SM block's keys with the SM2
    kernel's ok bits; its SM3 digests, keys and the default ID's
    midstate."""
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.ops import secp256k1, sm2, sm3
    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    qx, qy, _ = secp256k1.recover_device(*recover_inputs(payloads, sigs65, device))
    sm_payloads, sigs128, _ = sm2_tile(sm_block, BLOCK_TXS)
    data, starts, lengths, r, s, sqx, sqy = (
        torch.from_numpy(a).to(device) for a in admission.host_inputs_sm(sm_payloads, sigs128)
    )
    h = sm3.sm3_packed(data, starts, lengths)
    za = sm2.za_state(sm2_user_id(None), device)
    ok = sm2.verify_device(sm2.e_device(h, sqx, sqy), r, s, sqx, sqy)
    return {
        "keccak256_tx_hash": upload_packed(payloads, device),
        "keccak256_sender": (qx, qy),
        "sm3_sender": (sqx, sqy, ok),
        "sm3_e": (h, sqx, sqy, za),
    }


def measure_hash_forms(inputs: dict, launches: dict) -> list[dict]:
    """Each form on its path's timed inputs: equal to its plain version on
    every lane, both timed (CUDA events a call, the profiler's device time
    of the kernel alone), and its bound from the work its method does on
    these inputs: keccak's tx hash a permutation a 136-byte block of each
    payload; a sender one permutation or two compressions a key; e the
    compressions of ZA's rest after the midstate and two for e."""
    from fisco_bcos_tpu_torch.ops import _kernels, address, keccak, sm2

    plains = {
        "keccak256_tx_hash": keccak.keccak256_tx_hash_plain,
        "keccak256_sender": address.sender_address_plain,
        "sm3_sender": address.sm3_sender_address_plain,
        "sm3_e": lambda h, qx, qy, _za: sm2.e_plain(h, qx, qy),
    }
    data, starts, lengths = inputs["keccak256_tx_hash"]
    n_bytes = int(lengths.sum())
    za = sm2.za_midstate()
    e_blocks = (int(za[8]) + 64 + 8) // 64 + 1 + 2
    work = {  # (operations, bytes read and written, file:line replaced)
        "keccak256_tx_hash": (
            int((lengths.long() // 136 + 1).sum()) * KECCAK_F_OPS,
            n_bytes + BLOCK_TXS * (8 + 4 + 32 + 64), "fisco_bcos_tpu/ops/keccak.py:132"),
        "keccak256_sender": (BLOCK_TXS * KECCAK_F_OPS, BLOCK_TXS * (128 + 20 + 64),
                             "fisco_bcos_tpu/ops/address.py:32"),
        "sm3_sender": (BLOCK_TXS * 2 * SM3_COMPRESS_OPS, BLOCK_TXS * (128 + 1 + 20 + 64),
                       "fisco_bcos_tpu/ops/sm3.py:92"),
        "sm3_e": (BLOCK_TXS * e_blocks * SM3_COMPRESS_OPS, BLOCK_TXS * (32 + 128 + 64) + 128,
                  "fisco_bcos_tpu/ops/sm2.py:116"),
    }
    rows = []
    for name, args in inputs.items():
        kernel = getattr(_kernels, name)
        _, err, plain_ms = compare_and_time(kernel, plains[name], args, name, "timed block")
        ops, io, replaces = work[name]
        library = _kernels.KERNELS[name]
        row = kernel_row(name, f"fisco_bcos_tpu_torch/csrc/{library}.cu", replaces,
                         cuda_ms(lambda: kernel(*args)), ops, io, ops_kind="int32 instructions")
        row.update(max_abs_err=err, plain_ms=plain_ms, launches=launches[name],
                   device_ms=kernel_device_ms(lambda: kernel(*args)))
        rows.append(row)
    six = BLOCK_TXS * 6 * SM3_COMPRESS_OPS / INT32_MUL_PER_S * 1e3
    log(f"sm3_e bound: {e_blocks} compressions a lane after the midstate; {six:.4f} ms with the 6 of "
        f"two whole SM3 passes")
    return rows


def oracle_merkle_root(leaves, hasher: str, width: int = 16) -> bytes:
    """The host oracle of merkle_root, built with the port's crypto/ref
    hashes: the leaves zero-filled to their bucket, groups of `width`
    (the last one short), and H(padded root ‖ u64be(n))."""
    from fisco_bcos_tpu_torch.ops.merkle import bucket_leaves

    h = hash_fns(hasher)[2]
    n = len(leaves)
    level = [bytes(x) for x in leaves] + [bytes(32)] * (bucket_leaves(n) - n)
    while len(level) > 1:
        level = [h(b"".join(level[i : i + width])) for i in range(0, len(level), width)]
    return h(level[0] + n.to_bytes(8, "big"))


def check_merkle(card: str, device) -> tuple[dict[str, int], dict]:
    """merkle_root of each hasher at MERKLE_LEAVES leaves == the host
    oracle == the plain path, leaves given as numpy and on the card; the
    10,240-leaf tree's proofs; the 10,240-leaf root's launches (one a
    level) and time. Returns each packed kernel's launches on that root,
    and each hasher's (leaves, MerkleTree) of 10,240 leaves."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops import merkle

    gen = np.random.default_rng(SEED + 6)
    counts, trees = {}, {}
    for hasher in HASH_KERNELS:
        for n in MERKLE_LEAVES:
            leaves = gen.integers(0, 256, (n, 32), dtype=np.uint8)
            on_card = torch.from_numpy(leaves).to(device)
            roots = {
                "oracle": oracle_merkle_root(leaves, hasher),
                "card": merkle.merkle_root(leaves, hasher=hasher),
                "card leaves": merkle.merkle_root(on_card, hasher=hasher),
                "plain": merkle.merkle_root(leaves, hasher=hasher, device="cpu"),
            }
            if len(set(roots.values())) != 1:
                raise AssertionError(f"{hasher} merkle roots differ at {n} leaves: {roots}")
        # the largest tree (the last of MERKLE_LEAVES): proofs, launches, time
        tree = merkle.MerkleTree(leaves, hasher=hasher)
        if tree.root != roots["oracle"]:
            raise AssertionError(f"{hasher} MerkleTree root != oracle at {n} leaves")
        for i in (0, n // 2 + 1, n - 1):
            proof = tree.proof(i)
            if not merkle.MerkleTree.verify_proof(bytes(leaves[i]), i, n, proof, tree.root, hasher=hasher):
                raise AssertionError(f"{hasher} proof of leaf {i} rejected")
            if merkle.MerkleTree.verify_proof(bytes(leaves[i]), i ^ 1, n, proof, tree.root, hasher=hasher):
                raise AssertionError(f"{hasher} proof of leaf {i} accepted at another position")
        levels = len(tree.levels) - 1
        kernel = f"{hasher}_packed"
        _, launches = counted_run(
            lambda: merkle.merkle_root(on_card, hasher=hasher), {kernel: levels}, f"merkle_root ({hasher})"
        )
        ms = host_ms(lambda: merkle.merkle_root(on_card, hasher=hasher), reps=5)
        bind_ms = host_ms(lambda: merkle.bind_root(tree.padded_root, n, hasher), reps=5)
        log(f"[{card}] merkle_root ({hasher}, width 16) == host oracle == plain path at "
            f"{', '.join(map(str, MERKLE_LEAVES))} leaves; proofs of the {n}-leaf tree verify; "
            f"{n} leaves on the card: {ms:.3f} ms, {launches[kernel]} launches ({levels} levels), "
            f"of which the root binding on the host {bind_ms:.3f} ms")
        counts[kernel] = launches[kernel]
        trees[hasher] = (leaves, tree)
    return counts, trees


# ---------------------------------------------------------------------------
# The CryptoSuite seam
# ---------------------------------------------------------------------------

# a 4-node committee's signature list, one warp, 256 lanes (the JAX suite's
# host cutover), a block
SUITE_LANES = (4, 32, 256, BLOCK_TXS)
# batch_admit's branch for a suite other than the fused default: the fused
# path's launches a library, the keccak packed form in the tx-hash form's
# place (the SM suite's three calls launch exactly ADMIT_SM_LAUNCHES)
THREE_CALL_LAUNCHES = {"keccak256_packed": 1, "secp256k1_recover": 1, "keccak256_sender": 1}


def three_call_admission(suite, payloads, sigs):
    """What the JAX node's batch_admit runs for a suite other than the fused
    default (txpool/validator.py:143-149): hash_batch of the payloads ->
    batch_recover -> calculate_address_batch, the keys back on the host in
    between. Returns (senders, ok, pubkeys, tx hashes) as admit_batch
    does."""
    hashes = suite.hash_batch(payloads)
    pubs, ok = suite.signature_impl.batch_recover(hashes, sigs)
    return suite.calculate_address_batch(pubs), ok, pubs, hashes


def check_three_call(card: str, suite, fused, blocks, expected: dict, fused_expected: dict) -> None:
    """The suite's three-call admission on each (what, payloads, sigs, host
    oracle) block, counted: == the fused entry point == the host oracle on
    every lane; exactly `expected` launches, the same a library as the
    fused path's. On the last block: its wall time in turns with the fused
    entry's, its stages and one profiled call."""
    from fisco_bcos_tpu_torch.ops import _kernels

    name = suite.signature_impl.name
    entry = f"the {name} suite's three-call admission"
    if _kernels.library_launches(expected) != _kernels.library_launches(fused_expected):
        raise AssertionError(f"{entry}: expected launches a library differ from the fused path's")
    for what, payloads, sigs, want in blocks:
        got, launches = counted_run(lambda: three_call_admission(suite, payloads, sigs), expected, entry)
        check_outputs(got, want, what, entry)
        check_outputs(got, fused(payloads, sigs), what, entry, against="the fused path")
        log(f"{entry} on the {what}, {BLOCK_TXS} txs ({int(got[1].sum())} ok) == the fused path == "
            f"host oracle; launches {show_launches(launches)}")
    def three(p, s):
        return three_call_admission(suite, p, s)

    # the last block's payloads and signatures, fused and three-call in turns
    turns = [host_ms(lambda f=f: f(payloads, sigs), reps=5) for f in (fused, three, three, fused)]
    log(f"[{card}] {name} suite admission @ {BLOCK_TXS} txs, in turns (ms): fused {turns[0]:.2f}, "
        f"three-call {turns[1]:.2f}, three-call {turns[2]:.2f}, fused {turns[3]:.2f}")
    st: dict = {}

    def hash_batch():
        st["h"] = suite.hash_batch(payloads)

    def batch_recover():
        st["pubs"], _ = suite.signature_impl.batch_recover(st["h"], sigs)

    def calculate_address_batch():
        suite.calculate_address_batch(st["pubs"])

    stages = {fn.__name__: host_ms(fn, reps=3) for fn in (hash_batch, batch_recover, calculate_address_batch)}
    log(f"[{card}] {name} suite three-call stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log_busy(card, f"{name} suite three-call admission", lambda: three_call_admission(suite, payloads, sigs))


def plane_and_direct_ms(fn) -> list[float]:
    """`fn` through the DevicePlane (the default path) and direct
    (FISCO_DEVICE_PLANE=0), in turns plane, direct, direct, plane: the
    median ms of 5 warm calls each."""

    def direct():
        with passthrough():
            return fn()

    return [host_ms(f, reps=5) for f in (fn, direct, direct, fn)]


def show_turns(times: list[list[float]]) -> str:
    """Per size, "plane a / b, direct c / d" of plane_and_direct_ms."""
    return "; ".join(f"plane {t[0]:.3f} / {t[3]:.3f}, direct {t[1]:.3f} / {t[2]:.3f}" for t in times)


def same_outputs(got, want) -> bool:
    """Arrays, or tuples of arrays, equal in shape and every element."""
    import numpy as np

    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    return len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))


def check_suite_batches(card: str, ecdsa, sm, verify_cases, cases, sm_cases) -> None:
    """batch_verify and batch_recover of both suites on the first 4, 32,
    256 and 10,240 lanes of the mixed blocks: == the ops entry point == the
    host oracle, each call counted (its path's launches and none other, at
    every size) and timed."""
    import numpy as np

    from fisco_bcos_tpu_torch.ops import secp256k1, sm2

    hashes, rs, ss, pubs, verdicts = verify_arrays(verify_cases, BLOCK_TXS)
    sigs65 = np.concatenate([rs, ss, np.zeros((BLOCK_TXS, 1), np.uint8)], axis=1)  # v is not read
    _, rec_sigs, picked = tile(cases, BLOCK_TXS)
    _, rec_ok, rec_pubs, rec_hashes = expected_admission(picked)
    _, sigs128, sm_picked = sm2_tile(sm_cases, BLOCK_TXS)
    _, sm_ok, sm_pubs, sm_hashes = expected_admission_sm(sm_picked)
    sm_keys = sigs128[:, 64:]
    calls = (
        ("secp256k1 batch_verify", lambda n: ecdsa.signature_impl.batch_verify(hashes[:n], pubs[:n], sigs65[:n]),
         lambda n: secp256k1.verify_batch(hashes[:n], rs[:n], ss[:n], pubs[:n]),
         lambda n: verdicts[:n], {"secp256k1_verify": 1}),
        ("secp256k1 batch_recover", lambda n: ecdsa.signature_impl.batch_recover(rec_hashes[:n], rec_sigs[:n]),
         lambda n: secp256k1.recover_batch(rec_hashes[:n], rec_sigs[:n]),
         lambda n: (rec_pubs[:n], rec_ok[:n]), {"secp256k1_recover": 1}),
        ("sm2 batch_verify", lambda n: sm.signature_impl.batch_verify(sm_hashes[:n], sm_keys[:n], sigs128[:n]),
         lambda n: sm2.verify_batch(sm_hashes[:n], sigs128[:n, :32], sigs128[:n, 32:64], sm_keys[:n]),
         lambda n: sm_ok[:n], SM2_VERIFY_LAUNCHES),
        ("sm2 batch_recover", lambda n: sm.signature_impl.batch_recover(sm_hashes[:n], sigs128[:n]),
         lambda n: sm2.recover_batch(sm_hashes[:n], sigs128[:n]),
         lambda n: (sm_pubs[:n], sm_ok[:n]), SM2_VERIFY_LAUNCHES),
    )
    for what, suite_fn, ops_fn, oracle, launches in calls:
        times, oks = [], []
        for n in SUITE_LANES:
            got, counts = counted_run(lambda: suite_fn(n), launches, f"the suite's {what} at {n} lanes")
            if not same_outputs(got, ops_fn(n)) or not same_outputs(got, oracle(n)):
                raise AssertionError(f"the suite's {what} != the ops entry point / host oracle at {n} lanes")
            oks.append(int((got[1] if isinstance(got, tuple) else got).sum()))
            times.append(plane_and_direct_ms(lambda: suite_fn(n)))
        log(f"[{card}] suite {what} == ops entry point == host oracle at "
            + " / ".join(f"{n:,}" for n in SUITE_LANES) + " lanes (" + " / ".join(map(str, oks))
            + " ok); launches " + show_launches(counts) + " a call; ms a call " + show_turns(times))


def check_suite_merkle(card: str, suites, trees: dict) -> None:
    """merkle_root_async and merkle_tree through each suite over the
    10,240 leaves of check_merkle's tree: the same root, levels and proofs,
    one launch a level."""
    import numpy as np

    for suite in suites:
        hasher = suite.hash_impl.name
        leaves, tree = trees[hasher]
        n, levels, kernel = len(leaves), len(tree.levels) - 1, f"{hasher}_packed"
        what = f"the {suite.signature_impl.name} suite's merkle"
        root, _ = counted_run(lambda: suite.merkle_root_async(leaves)(), {kernel: levels}, f"{what} root")
        got, _ = counted_run(lambda: suite.merkle_tree(leaves), {kernel: levels}, f"{what} tree")
        if root != tree.root or got.root != tree.root or len(got.levels) != len(tree.levels):
            raise AssertionError(f"{what} root or depth != ops.merkle's at {n} leaves")
        if not all(np.array_equal(a, b) for a, b in zip(got.levels, tree.levels)):
            raise AssertionError(f"{what} tree levels != ops.merkle's at {n} leaves")
        if any(got.proof(i) != tree.proof(i) for i in (0, n // 2 + 1, n - 1)):
            raise AssertionError(f"{what} proofs != ops.merkle's at {n} leaves")
        ms = host_ms(lambda: suite.merkle_root_async(leaves)(), reps=5)
        log(f"[{card}] {what} root and tree ({hasher}) == ops.merkle at {n} leaves, {levels} launches "
            f"each; root {ms:.3f} ms")


def run_suite_phase(card: str, block, cases, sm_block, sm_cases, verify_cases, trees: dict) -> None:
    """The CryptoSuite seam: ecdsa_suite() and sm_suite() built on the card
    and driven as the JAX node drives its suite, on the blocks of the
    earlier phases: the three-call admission, batch_verify and
    batch_recover at SUITE_LANES lanes, the merkle root and tree."""
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch, admit_batch_sm
    from fisco_bcos_tpu_torch.crypto.suite import ecdsa_suite, sm_suite

    ecdsa, sm = ecdsa_suite(), sm_suite()
    if ecdsa.device.type != "cuda" or sm.device != ecdsa.device:
        raise AssertionError(f"the suites are not on the card: {ecdsa.device}, {sm.device}")

    def secp_block(what, rows):
        payloads, sigs65, picked = tile(rows, BLOCK_TXS)
        return what, payloads, sigs65, expected_admission(picked)

    def sm_block_of(what, rows):
        payloads, sigs128, picked = sm2_tile(rows, BLOCK_TXS)
        return what, payloads, sigs128, expected_admission_sm(picked)

    check_three_call(card, ecdsa, admit_batch,
                     [secp_block("mixed block", cases), secp_block("timed block", block)],
                     THREE_CALL_LAUNCHES, ADMIT_LAUNCHES)
    check_three_call(card, sm, admit_batch_sm,
                     [sm_block_of("SM2 mixed block", sm_cases), sm_block_of("SM timed block", sm_block)],
                     ADMIT_SM_LAUNCHES, ADMIT_SM_LAUNCHES)
    check_suite_batches(card, ecdsa, sm, verify_cases, cases, sm_cases)
    check_suite_merkle(card, (ecdsa, sm), trees)


# ---------------------------------------------------------------------------
# Ed25519: the kernel, verify_batch and the suite's Ed25519Crypto
# ---------------------------------------------------------------------------

# QC committees of 4 and 7 (consensus/qc.py verify_cert: one batch a
# quorum), a few hundred lanes, a 10k block
ED25519_LANES = (4, 7, 100, BLOCK_TXS)
# the challenge kernel's timed lanes: the QC shapes (4, 7), one warp, one
# warp a SM, the block
CHALLENGE_LANES = (4, 7, 32, 132 * 32, BLOCK_TXS)
ED25519_VERIFY_LAUNCHES = {"ed25519_challenge": 1, "ed25519_verify": 1}
# the mixed block's message lengths: with the 64-byte prefix R ‖ A, every
# SHA-512 padding edge (47/48/49 spill the length field, 63/64/65 fill a
# block, 175/176 and 191/192 the same a block later), then 0-300 bytes
ED25519_EDGE_LENGTHS = (0, 1, 32, 47, 48, 49, 63, 64, 65, 111, 112, 175, 176, 191, 192, 255, 256, 300)
# the kernel's field ops mod 2^255 - 19 (csrc/ed25519_verify.cu): the 8x8
# (or 36) word products, the fold of the high half by 38 (8) and of the top
# by 19 (1)
MULS_FE_MUL = 2 * (64 + 8 + 1)
MULS_FE_SQR = 2 * (36 + 8 + 1)
ED25519_RECODE = int("8" * 64, 16)  # 8 in every 4-bit window
# SHA-512 on 32-bit halves (csrc/ed25519_challenge.cu), by the hash bound
# rule (a LOP3, a funnel shift or a 3-input add counts one; a 64-bit value
# is two halves): a round is Σ1 (3 rotations, 6 shifts, 2 LOP3), Ch (2),
# T1's five terms (2 three-input adds a half), Σ0 (8), Maj (2), T2, e and a
# (2 each); the schedule's 64 words σ0 and σ1 (8 each: 4 rotation shifts, 2
# for the shift, 2 LOP3) and the sum of four (4); the chaining value's 8
# adds (2 each)
SHA512_ROUND_OPS = 8 + 2 + 4 + 8 + 2 + 2 + 2 + 2
SHA512_BLOCK_OPS = 80 * SHA512_ROUND_OPS + 64 * 20 + 8 * 2
# the Barrett reduction of the digest mod L: ⌊x / 2^224⌋·μ, 9 x 9 word
# products (μ has no word of 0 or 1); the low 288 bits of q·L, the products
# by L's 4 low words (its words 4-6 are 0, word 7 a power of two), those
# landing in word 8 needing their low half only
MULS_MOD_L = 2 * 81 + 2 * (9 + 8 + 7 + 6) - 4


def ed25519_order8_point():
    """T8 = L·P for decompressed P, the first whose order is 8 (reference
    point arithmetic)."""
    from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref

    y = 2
    while True:
        pt = ref._decompress(y.to_bytes(32, "little"))
        if pt is not None:
            t = ref._mul(ref.L, pt)
            if not ref._eq_points(ref._mul(4, t), ref.IDENT):
                return t
        y += 1


def make_ed25519_cases(n_unique: int, seed: int):
    """(msg, pub32, sig64, the host oracle's verdict) rows from seeded
    signers, one lane in 16 of each kind: tampered R, S or message; another
    signer's key; a key or an R with y >= p, with x = 0 and the sign bit
    set, or with no root; s >= L; and lanes the cofactored equation
    accepts: small-order keys (the identity, y = -1, y = 0 with either
    sign, an order-8 point) with s = r, a small-order R with s = k·a,
    mixed-order R = r·B + T8 and keys a·B + T8, and the all-zero row.
    Messages run through ED25519_EDGE_LENGTHS, then 0-300 bytes."""
    from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref

    P, L = ref.P, ref.L
    rng = random.Random(seed)
    t8 = ed25519_order8_point()
    enc = lambda y, sign=0: (y | sign << 255).to_bytes(32, "little")  # noqa: E731
    no_root = next(y for y in range(2, P) if ref._decompress(enc(y)) is None)
    small = (enc(1), enc(P - 1), enc(0), enc(0, 1), ref._compress(t8))

    def sign_with(a, pub, msg, r, extra=None):  # R = r·B (+ extra), s = r + k·a
        rpt = ref._mul(r, ref.BASE)
        rpt = rpt if extra is None else ref._add(rpt, extra)
        rc = ref._compress(rpt)
        k = int.from_bytes(ref._sha512(rc + pub + msg), "little") % L
        return rc + ((r + k * a) % L).to_bytes(32, "little")

    rows = []
    for i in range(n_unique):
        sk = rng.randbytes(32)
        a, pub = ref._clamp(ref._sha512(sk)), ref.seed_to_pubkey(sk)
        edges = ED25519_EDGE_LENGTHS
        msg = rng.randbytes(edges[i % len(edges)] if i < 2 * len(edges) else rng.randrange(301))
        sig = ref.sign(sk, msg)
        s = int.from_bytes(sig[32:], "little")
        r = rng.randrange(1, L)
        variant, j = i % 16, (i // 16) % 5
        if variant == 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif variant == 2:
            sig = sig[:33] + bytes([sig[33] ^ 0x10]) + sig[34:]
        elif variant == 3:
            msg = msg + b"!"
        elif variant == 4:
            pub = ref.seed_to_pubkey(rng.randbytes(32))
        elif variant == 5:
            bad = (enc(P), b"\xff" * 31 + b"\x7f", enc(P + 2, 1))[j % 3]
            pub, sig = (bad, sig) if j % 2 else (pub, bad + sig[32:])
        elif variant == 6:
            bad = enc((1, P - 1)[j % 2], 1)  # x = 0, sign 1
            pub, sig = (bad, sig) if j < 3 else (pub, bad + sig[32:])
        elif variant == 7:
            pub, sig = (enc(no_root), sig) if j % 2 else (pub, enc(no_root) + sig[32:])
        elif variant == 8:
            sig = sig[:32] + (L, (1 << 256) - 1, s + L)[j % 3].to_bytes(32, "little")
        elif variant == 9:
            pub = small[j]
            sig = sign_with(0, pub, msg, r)
        elif variant == 10:
            sig = sign_with(a, pub, msg, 0, t8 if j % 2 else None)
        elif variant == 11:
            sig = sign_with(a, pub, msg, r, t8)
        elif variant == 12:
            pub = ref._compress(ref._add(ref._mul(a, ref.BASE), t8))
            sig = sign_with(a, pub, msg, r)
        elif variant == 13:
            msg, pub, sig = b"", bytes(32), bytes(64)
        rows.append((msg, pub, sig, ref.verify(pub, msg, sig)))
    return rows


def make_ed25519_bench_block(n_unique: int):
    """Valid signatures of 32-byte messages (a QC vote preimage's size) from
    seeded signers, over the timed admission block's payload hashes; rows
    as make_ed25519_cases makes them."""
    from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    rows = []
    for i in range(n_unique):
        sk = (0xED25519 + 104729 * i).to_bytes(32, "little")
        msg = keccak256(b"bench parallel-transfer tx %06d" % i + b"\xab" * 64)
        pub, sig = ref.seed_to_pubkey(sk), ref.sign(sk, msg)
        rows.append((msg, pub, sig, ref.verify(pub, msg, sig)))
    return rows


def ed25519_tile(rows, n: int):
    """Tile (msg, pub, sig, verdict) rows to n lanes: (msgs, pubs, sigs)
    lists and the host oracle's verdicts."""
    import numpy as np

    picked = [rows[i % len(rows)] for i in range(n)]
    return tuple([r[k] for r in picked] for k in range(3)), np.array([r[3] for r in picked])


def ed25519_digits(k: int) -> list[int]:
    """The kernel's signed digits of a scalar (any 256-bit k), MSB first:
    window i of k + 0x88..8 (mod 2^256), less 8."""
    kk = (k + ED25519_RECODE) % (1 << 256)
    return [((kk >> (4 * i)) & 15) - 8 for i in range(63, -1, -1)]


def ed25519_verify_multiplies(s: int, k_neg: int) -> int:
    """32-bit multiplies of the least work the Ed25519 kernel's method
    needs for one signature: two decompressions (255 squarings and 19
    products each: the chain of (p-5)/8, v³, v⁷, the checks; then x·y and
    2d·x·y, 2 products), the table of A (7 additions of 8 products and a
    cached form of 1), the ladder over this lane's signed digits (a
    window's 4 doublings 4 squarings and 3 products each, and the product
    of T where an addition follows; an addition of A 8 products, of the B
    comb 7; the doublings of the still-identity accumulator and the first
    addition to it are no work), then - R (8) and 3 doublings without T.
    The quad's doubling writes T every time, a fourth product the function
    does not need; the bound leaves that overhead out."""
    sqr, mul = 2 * 255 + 3 * 4, 2 * (19 + 2) + 7 * 9 + 8 + 3 * 3
    started = False
    for dk, ds in zip(ed25519_digits(k_neg), ed25519_digits(s)):
        if started:
            sqr, mul = sqr + 16, mul + 12 + (1 if dk or ds else 0)
        for d, cost in ((dk, 8), (ds, 7)):
            if d:
                mul += cost if started else 0
                started = True
    return sqr * MULS_FE_SQR + mul * MULS_FE_MUL


def ed25519_challenge_ops(msg_len: int) -> int:
    """32-bit integer operations of the challenge kernel's method for one
    message: SHA-512 over R ‖ A ‖ M padded (a block is SHA512_BLOCK_OPS),
    and the reduction's multiplies."""
    return ((64 + msg_len + 16) // 128 + 1) * SHA512_BLOCK_OPS + MULS_MOD_L


def ed25519_rows_tensor(msgs, pubs, sigs, device):
    """The host's rows on the card: [n, 128] uint8, challenges hashed on
    the host (device_inputs), the oracle of the challenge kernel's rows."""
    import torch

    from fisco_bcos_tpu_torch.ops import ed25519

    return torch.from_numpy(ed25519.device_inputs(msgs, pubs, sigs, pad_to=len(msgs))).to(device)


def ed25519_challenge_args(msgs, pubs, sigs, device):
    """The challenge kernel's inputs on the card: the [n, 128] rows with
    k_neg zero and the packed messages."""
    import torch

    from fisco_bcos_tpu_torch.ops import ed25519
    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    rows = torch.from_numpy(ed25519.signature_rows(pubs, sigs, pad_to=len(msgs))).to(device)
    return (rows, *upload_packed(msgs, device))


def check_ed25519_block(rows, device, what: str) -> dict:
    """On a 10,240-lane block: the challenge kernel == challenge_plain on
    every lane (fresh rows each), and its rows == device_inputs (the host's
    hashlib challenges) byte for byte; the verify kernel == verify_plain on
    every lane, and on the first 4, 7, 100 and 10,240 lanes alone == the
    plain verdicts and the host oracle there; challenge_rows at those sizes
    == device_inputs, the bucket's zero rows included; verify_batch == the
    host oracle. Returns the kernels' largest differences and plain ms."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops import ed25519

    (msgs, pubs, sigs), want = ed25519_tile(rows, BLOCK_TXS)
    host_rows = ed25519_rows_tensor(msgs, pubs, sigs, device)
    args = ed25519_challenge_args(msgs, pubs, sigs, device)
    fresh = lambda: (args[0].clone(), *args[1:])  # noqa: E731  (both write their rows)
    kernel_rows = ed25519.challenge_device(*fresh())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_rows = ed25519.challenge_plain(*fresh())
    torch.cuda.synchronize()
    ch_plain_ms = (time.perf_counter() - t0) * 1e3
    for name, got in (("challenge_plain", plain_rows), ("the host's device_inputs", host_rows)):
        if not torch.equal(kernel_rows, got):
            bad = (kernel_rows != got).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"ed25519_challenge rows != {name} on the {what}, lanes {bad}")
    ch_err = int((kernel_rows.to(torch.int64) - plain_rows.to(torch.int64)).abs().max())
    kernel_ok, err, plain_ms = compare_and_time(
        ed25519.verify_device, ed25519.verify_plain, (host_rows,), "ed25519_verify", what,
    )
    plain_ok = kernel_ok.cpu().numpy()
    if not np.array_equal(plain_ok, want):
        raise AssertionError(f"ed25519 verify kernel != host oracle on the {what}")
    for n in ED25519_LANES:
        got = ed25519.verify_device(host_rows[:n]).cpu().numpy()
        if not np.array_equal(got, plain_ok[:n]) or not np.array_equal(got, want[:n]):
            raise AssertionError(f"ed25519 verify kernel at {n} lanes != verify_plain / host oracle on the {what}")
        made = ed25519.challenge_rows(msgs[:n], pubs[:n], sigs[:n]).cpu().numpy()
        if not np.array_equal(made, ed25519.device_inputs(msgs[:n], pubs[:n], sigs[:n])):
            raise AssertionError(f"ed25519.challenge_rows at {n} lanes != device_inputs on the {what}")
    if not np.array_equal(ed25519.verify_batch(msgs, pubs, sigs), want):
        raise AssertionError(f"ed25519.verify_batch != host oracle on the {what}")
    lens = [len(m) for m in msgs]
    log(f"{what}, {BLOCK_TXS} lanes ({int(want.sum())} accepted; messages of {min(lens)}-{max(lens)} "
        f"bytes): challenge kernel == plain == the host's rows; verify kernel == plain == host oracle, "
        f"also at " + " / ".join(f"{n:,}" for n in ED25519_LANES) + " lanes alone; challenge_rows == "
        f"device_inputs there; verify_batch == host oracle")
    return {"challenge": (ch_err, ch_plain_ms), "verify": (err, plain_ms)}


def run_ed25519_path(rows) -> tuple[dict, float]:
    """ed25519.verify_batch on the timed block, counted: one launch of the
    challenge kernel and one of the verify kernel, every plain version (and
    the host challenges) made to raise. Returns (the launches a kernel, the
    median end-to-end ms)."""
    import numpy as np

    from fisco_bcos_tpu_torch.ops import ed25519

    (msgs, pubs, sigs), want = ed25519_tile(rows, BLOCK_TXS)
    got, launches = counted_run(
        lambda: ed25519.verify_batch(msgs, pubs, sigs), ED25519_VERIFY_LAUNCHES, "ed25519.verify_batch"
    )
    if not np.array_equal(got, want) or not got.all():
        raise AssertionError("ed25519.verify_batch != host oracle on the timed block")
    log(f"Ed25519 path: verify_batch on {BLOCK_TXS} signatures == host oracle; "
        f"launches {show_launches(launches)}")
    return launches, host_ms(lambda: ed25519.verify_batch(msgs, pubs, sigs), reps=5)


def ed25519_stages(rows, device, parent=None) -> dict[str, float]:
    """Median ms of each stage of ed25519.verify_batch on the timed block,
    each run warm and ending synchronised: host_pad (the byte joins of R ‖ S
    ‖ A and the pack of the messages), upload (rows and packed messages),
    challenge (the kernel), verify (the kernel), download. With `parent`
    (another checkout's kernels module), the same stages through that
    checkout's two kernels."""
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels, ed25519
    from fisco_bcos_tpu_torch.ops.hash_common import pack_messages

    (msgs, pubs, sigs), _ = ed25519_tile(rows, BLOCK_TXS)
    kernels = parent or _kernels
    comb = ed25519.comb_words(device)
    st: dict = {}

    def host_pad():
        st["host"] = (ed25519.signature_rows(pubs, sigs), *pack_messages(msgs))

    def upload():
        st["dev"] = [torch.from_numpy(a).to(device) for a in st["host"]]

    def challenge():
        kernels.ed25519_challenge(*st["dev"])

    def verify():
        st["ok"] = kernels.ed25519_verify(st["dev"][0], comb)

    def download():
        st["ok"].cpu().numpy()

    return {fn.__name__: host_ms(fn, reps=3) for fn in (host_pad, upload, challenge, verify, download)}


def measure_ed25519_kernels(card: str, rows, device) -> tuple[dict, dict]:
    """Both kernels on the timed block: their times at ED25519_LANES lanes
    (CUDA events) and their rows, with the bounds from this run's digits
    and messages."""
    from fisco_bcos_tpu_torch.ops import ed25519

    (msgs, pubs, sigs), _ = ed25519_tile(rows, BLOCK_TXS)
    dev_rows = ed25519_rows_tensor(msgs, pubs, sigs, device)
    ch_rows, data, starts, lengths = ed25519_challenge_args(msgs, pubs, sigs, device)
    times = {
        "ed25519_verify": [cuda_ms(lambda n=n: ed25519.verify_device(dev_rows[:n])) for n in ED25519_LANES],
    }
    log(f"[{card}] ed25519_verify kernel at " + " / ".join(f"{n:,}" for n in ED25519_LANES)
        + " lanes: " + " / ".join(f"{x:.4f}" for x in times["ed25519_verify"]) + " ms")
    shown = []
    for n in CHALLENGE_LANES:
        part = (ch_rows[:n], data, starts[:n], lengths[:n])  # cut once, outside the timed calls
        fn = lambda part=part: ed25519.challenge_device(*part)  # noqa: E731
        times.setdefault("ed25519_challenge", []).append(cuda_ms(fn))
        shown.append((n, times["ed25519_challenge"][-1], kernel_device_ms(fn),
                      ed25519_challenge_ops(max(len(m) for m in msgs[:n]))))
    mhz = sm_clock_mhz()  # once, after the timings
    log(f"[{card}] ed25519_challenge kernel on the timed block: " + "; ".join(
        f"{n:,}: call {ms:.4f} ms, alone {show_device_ms(alone)}, one-warp floor "
        f"{one_warp_floor_ms(cycles, mhz):.4f} ms" for n, ms, alone, cycles in shown) + f" (floors at {mhz} MHz)")
    host = dev_rows[: len(rows)].cpu().numpy()
    per_case = [ed25519_verify_multiplies(int.from_bytes(bytes(r[32:64]), "little"),
                                          int.from_bytes(bytes(r[96:]), "little")) for r in host]
    muls = sum(per_case[i % len(rows)] for i in range(BLOCK_TXS))
    verify = kernel_row(
        "ed25519_verify", "fisco_bcos_tpu_torch/csrc/ed25519_verify.cu",
        "fisco_bcos_tpu/ops/ed25519.py:286", times["ed25519_verify"][-1], muls,
        io_bytes=BLOCK_TXS * (ed25519.ROW_BYTES + 1) + 24 * 8 * 4,
    )
    lens = [len(m) for m in msgs]
    challenge = kernel_row(
        "ed25519_challenge", "fisco_bcos_tpu_torch/csrc/ed25519_challenge.cu",
        "fisco_bcos_tpu/ops/ed25519.py:328", times["ed25519_challenge"][-1],
        sum(ed25519_challenge_ops(n) for n in lens),
        io_bytes=sum(lens) + BLOCK_TXS * (64 + 32 + 8 + 4), ops_kind="int32 operations",
    )
    return verify, challenge


def ed25519_against_parent(card: str, parent, rows, device) -> None:
    """In turns parent, new, new, parent: the verify kernel against the
    parent checkout's at 4, 7, 100 and 10,240 lanes of the timed block
    (CUDA events; equal on every lane); then verify_batch at 4, 7 and
    10,240 lanes and the QC check (Ed25519Crypto.batch_verify, as
    Ed25519QCScheme.verify_cert calls it) at 4 and 7, with the parent
    checkout's challenge kernel in the path and with this checkout's (host
    clock a call, synchronised; equal verdicts). The challenge kernels
    themselves are timed against each other in time_against_parent."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.crypto.suite import Ed25519Crypto
    from fisco_bcos_tpu_torch.ops import _kernels, ed25519

    (msgs, pubs, sigs), want = ed25519_tile(rows, BLOCK_TXS)
    dev_rows = ed25519_rows_tensor(msgs, pubs, sigs, device)
    comb = ed25519.comb_words(device)
    for n in ED25519_LANES:
        old = lambda n=n: parent.ed25519_verify(dev_rows[:n], comb)  # noqa: E731
        new = lambda n=n: ed25519.verify_device(dev_rows[:n])  # noqa: E731
        if not torch.equal(old(), new()):
            raise AssertionError(f"ed25519_verify != the parent checkout's at {n} lanes")
        v = [cuda_ms(f) for f in (old, new, new, old)]
        log(f"[{card}] ed25519_verify at {n:,} lanes, in turns with the parent checkout: parent {v[0]:.4f}, "
            f"new {v[1]:.4f}, new {v[2]:.4f}, parent {v[3]:.4f} ms (new/parent {(v[1] + v[2]) / (v[0] + v[3]):.3f})")
    if getattr(parent, "ed25519_challenge", None) is None:
        log(f"[{card}] the parent checkout has no challenge kernel: its paths are not timed against this one's")
        return
    impl = Ed25519Crypto(device)
    ours = _kernels.ed25519_challenge

    def with_parent(fn):
        def run():
            _kernels.ed25519_challenge = parent.ed25519_challenge
            try:
                return fn()
            finally:
                _kernels.ed25519_challenge = ours
        return run

    calls = [("verify_batch", n, lambda n=n: ed25519.verify_batch(msgs[:n], pubs[:n], sigs[:n]))
             for n in (4, 7, BLOCK_TXS)]
    calls += [("QC check (Ed25519Crypto.batch_verify)", n, lambda n=n: impl.batch_verify(msgs[:n], pubs[:n], sigs[:n]))
              for n in (4, 7)]
    for what, n, fn in calls:
        if not (np.array_equal(fn(), want[:n]) and np.array_equal(with_parent(fn)(), want[:n])):
            raise AssertionError(f"{what} at {n} lanes != host oracle, with this or the parent's challenge kernel")
        t = [host_ms(f, reps=9) for f in (with_parent(fn), fn, fn, with_parent(fn))]
        log(f"[{card}] {what} at {n:,} lanes, the parent checkout's challenge kernel in the path and this "
            f"one's, in turns: parent {t[0]:.4f}, new {t[1]:.4f}, new {t[2]:.4f}, parent {t[3]:.4f} ms "
            f"(new/parent {(t[1] + t[2]) / (t[0] + t[3]):.3f})")


def check_ed25519_suite(card: str, cases, device) -> None:
    """Ed25519Crypto() on the card, as the QC scheme drives it
    (Ed25519QCScheme.verify_cert: one batch_verify a quorum):
    batch_verify and batch_recover (R ‖ S ‖ key signatures) on the first
    4, 7, 100 and 10,240 lanes of the mixed block, counted, == the ops entry
    point == the host oracle, and timed."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto.suite import Ed25519Crypto
    from fisco_bcos_tpu_torch.ops import ed25519

    impl = Ed25519Crypto(device)
    (msgs, pubs, sigs), want = ed25519_tile(cases, BLOCK_TXS)
    carried = [s + p for s, p in zip(sigs, pubs)]
    keys = np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32)
    calls = (
        ("batch_verify", lambda n: impl.batch_verify(msgs[:n], pubs[:n], sigs[:n]),
         lambda n: ed25519.verify_batch(msgs[:n], pubs[:n], sigs[:n]), lambda n: want[:n]),
        ("batch_recover", lambda n: impl.batch_recover(msgs[:n], carried[:n]),
         lambda n: (np.where(want[:n, None], keys[:n], 0).astype(np.uint8),
                    ed25519.verify_batch(msgs[:n], pubs[:n], sigs[:n])),
         lambda n: (np.where(want[:n, None], keys[:n], 0).astype(np.uint8), want[:n])),
    )
    for what, suite_fn, ops_fn, oracle in calls:
        times, oks = [], []
        for n in ED25519_LANES:
            got, counts = counted_run(lambda: suite_fn(n), ED25519_VERIFY_LAUNCHES,
                                      f"Ed25519Crypto.{what} at {n} lanes")
            if not same_outputs(got, ops_fn(n)) or not same_outputs(got, oracle(n)):
                raise AssertionError(f"Ed25519Crypto.{what} != the ops entry point / host oracle at {n} lanes")
            oks.append(int((got[1] if isinstance(got, tuple) else got).sum()))
            times.append(plane_and_direct_ms(lambda: suite_fn(n)))
        log(f"[{card}] Ed25519Crypto.{what} == ops entry point == host oracle at "
            + " / ".join(f"{n:,}" for n in ED25519_LANES) + " lanes (" + " / ".join(map(str, oks))
            + " ok); launches " + show_launches(counts) + " a call; ms a call " + show_turns(times))


def ed25519_residency(card: str, device) -> None:
    """The verify kernel's blocks resident on one SM (the occupancy API)
    against the blocks of a 10,240-lane launch."""
    import ctypes

    import torch

    from fisco_bcos_tpu_torch.ops import _kernels

    fn = _kernels._library("ed25519_verify").ed25519_verify_resident_blocks
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    per_sm = fn(device.index)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    geo = _kernels.geometry("ed25519_verify", BLOCK_TXS)
    log(f"[{card}] ed25519_verify at {BLOCK_TXS:,} lanes: {geo['blocks']:,} blocks of {geo['threads']} threads, "
        f"{BLOCK_TXS // geo['blocks']} signatures (a quad of lanes each) and {geo['dynamic_shared_bytes']:,} B of "
        f"dynamic shared memory a block; {per_sm} blocks resident a SM x {sms} SMs = {per_sm * sms:,} "
        + ("(all resident at once)" if per_sm * sms >= geo["blocks"] else "(NOT all resident: a second wave)"))


def run_ed25519_phase(card: str, device, parent=None) -> tuple[list, list, list]:
    """Ed25519 (ROADMAP A3, B5): both kernels against their plain versions
    on a mixed and a timed block, verify_batch against the host oracle and
    counted, its stages (with `parent`, the parent's composition in turns),
    the kernels' times and rows, and the suite's Ed25519Crypto. Returns
    (the kernels' rows, the timed block, the mixed cases)."""
    from fisco_bcos_tpu_torch.ops import ed25519

    t0 = time.perf_counter()
    cases = make_ed25519_cases(UNIQUE_SIGNERS, SEED + 5)
    block = make_ed25519_bench_block(BENCH_SIGNERS)
    log(f"Ed25519: {len(cases)} mixed cases, {len(block)} valid signers; built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    ed25519_residency(card, device)
    mixed = check_ed25519_block(cases, device, "Ed25519 mixed block")
    timed = check_ed25519_block(block, device, "Ed25519 timed block")
    launches, batch_ms = run_ed25519_path(block)
    rows = measure_ed25519_kernels(card, block, device)
    for row in rows:
        row.update(launches=launches[row["name"]], plain_ms=timed[row["name"].split("_")[1]][1],
                   max_abs_err=max(mixed[row["name"].split("_")[1]][0], timed[row["name"].split("_")[1]][0]))
        log_kernel(card, row)
    log(f"[{card}] ed25519.verify_batch @ {BLOCK_TXS} signatures: {batch_ms:.2f} ms end to end "
        f"({BLOCK_TXS / batch_ms * 1e3:.0f} verifies/s)")
    for who in ((parent, None, None, parent) if parent else (None,)):
        stages = ed25519_stages(block, device, who)
        log(f"[{card}] ed25519.verify_batch stages{' (parent checkout)' if who else ''} (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    if parent is not None:
        ed25519_against_parent(card, parent, block, device)
    (msgs, pubs, sigs), _ = ed25519_tile(block, BLOCK_TXS)
    log_busy(card, "ed25519.verify_batch", lambda: ed25519.verify_batch(msgs, pubs, sigs))
    check_ed25519_suite(card, cases, device)
    return list(rows), block, cases


# ---------------------------------------------------------------------------
# Poseidon: the kernel, the suite and the succinct state plane's commitment
# ---------------------------------------------------------------------------

POSEIDON_EDGE_LENGTHS = (0, 30, 31, 32, 61, 62, 63, 123, 124, 125)  # every 31/62-byte edge
# 32-bit multiplies of the least work of a Poseidon permutation, a 32x32->64
# word product counted as two and a low half as one: a Montgomery product's
# 64 word products, a squaring's 36, and its REDC's 8 steps, each a factor
# m = t_i·n0 (a low half) and m·FR (8 word products; no word of FR is 0 or 1);
# a row of a mix sums its products before one REDC. The least form is the
# instance's optimized one (eprint 2019/458, Appendix B), with the same output:
# the MDS factored so that each of the 57 partial rounds mixes by a sparse
# matrix (word 0 a row of three products, words 1 and 2 one product each: 5
# products, 3 REDCs) and the 8 full rounds by a dense 3x3 (the last round of
# the first half by the MDS times the factor moved out of the partial rounds,
# no extra mix). The kernel (csrc/poseidon.cu) runs that form, four lanes a
# message, its idle lanes' sink products not counted.
MULS_FR_REDC = 8 * (1 + 2 * 8)
MULS_FR_MUL = 2 * 64 + MULS_FR_REDC
MULS_FR_SQR = 2 * 36 + MULS_FR_REDC
MULS_FR_MDS_ROW = 3 * 2 * 64 + MULS_FR_REDC
MULS_FR_SBOX = 2 * MULS_FR_SQR + MULS_FR_MUL  # x^5 = (x^2)^2·x
MULS_FR_SPARSE_MIX = MULS_FR_MDS_ROW + 2 * MULS_FR_MUL
# 8 full rounds (three S-boxes, a dense mix) and 57 partial (one, a sparse mix)
POSEIDON_PERM_MULS = (8 * 3 + 57) * MULS_FR_SBOX + 8 * 3 * MULS_FR_MDS_ROW + 57 * MULS_FR_SPARSE_MIX
# a block: the permutation and its two elements' encoding (a product by
# R^2 each, counted); a message: its blocks, then the squeeze (a REDC)
POSEIDON_BLOCK_MULS = POSEIDON_PERM_MULS + 2 * MULS_FR_MUL
POSEIDON_REPLACES = "fisco_bcos_tpu/ops/poseidon.py:127"
# the succinct state plane at its defaults (FISCO_STATE_PAGES = 64): a
# million-key DAG-transfer state, and one 10,240-transaction block's delta
# (a transfer writes two balances: 20,480 keys)
STATE_KEYS = 1 << 20
STATE_PAGES = 64
DAG_TABLE = b"dag_transfer"
COMMIT_SAMPLE = 128  # lanes of each level held against the plain version
ORACLE_SAMPLE = 1024  # rows and leaf messages held against the host oracle


def poseidon_message_muls(n: int) -> int:
    return (n // 62 + 1) * POSEIDON_BLOCK_MULS + MULS_FR_REDC


def poseidon_kernel_fn(device):
    """The Poseidon kernel's wrapper with the instance's table on `device`:
    packed args -> [B, 32] uint8."""
    from fisco_bcos_tpu_torch.ops import _kernels, poseidon

    table = poseidon.kernel_table(device)
    return lambda data, starts, lengths: _kernels.poseidon_packed(data, starts, lengths, table)


def poseidon_row(kernel_ms: float, lengths) -> dict:
    """The Poseidon kernel's line for messages of `lengths`: its bound is
    the least multiplies they need, the bytes each message's read and its
    digest, start and length."""
    return kernel_row(
        "poseidon_packed", "fisco_bcos_tpu_torch/csrc/poseidon.cu", POSEIDON_REPLACES, kernel_ms,
        sum(map(poseidon_message_muls, lengths)), io_bytes=sum(lengths) + len(lengths) * (8 + 4 + 32),
    )


ORACLE_WORKERS = max(1, min(8, os.cpu_count() or 1))


@contextlib.contextmanager
def oracle_pool():
    """Worker processes for the host oracle (spawned: each imports the
    oracle's module alone), stopped when the block ends."""
    import multiprocessing

    with ProcessPoolExecutor(ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool


def oracle_poseidon(pool, msgs) -> list[bytes]:
    """The port's host oracle of each message, on `pool`'s workers."""
    from fisco_bcos_tpu_torch.crypto.ref.poseidon import poseidon_hash

    return list(pool.map(poseidon_hash, msgs, chunksize=max(1, len(msgs) // (4 * ORACLE_WORKERS))))


def poseidon_mixed_messages() -> list[bytes]:
    """Poseidon's mixed block: every 31/62-byte edge, then seeded lengths of
    0-700 bytes (1 to 12 sponge blocks)."""
    rng = random.Random(SEED + 12)
    lengths = list(POSEIDON_EDGE_LENGTHS) + [
        rng.randrange(701) for _ in range(HASH_MIXED - len(POSEIDON_EDGE_LENGTHS))
    ]
    return [rng.randbytes(n) for n in lengths]


def check_poseidon_block(card: str, device, pool):
    """The kernel on the mixed block tiled to 10,240 lanes == its plain
    version on every lane (timed) == the oracle on the 4,096 distinct
    messages; the same block with shuffled starts and 5 bytes off 16-byte
    alignment == the first run lane for lane; a [4,096, 64] row block (the
    address form's input) == plain, its first ORACLE_SAMPLE rows == oracle. Returns (largest difference,
    plain ms, the tiled block's packed args, its messages)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops import poseidon
    from fisco_bcos_tpu_torch.ops.hash_common import rows_as_packed, upload_packed

    kernel = poseidon_kernel_fn(device)
    mixed = poseidon_mixed_messages()
    tiled = [mixed[i % len(mixed)] for i in range(BLOCK_TXS)]
    args = upload_packed(tiled, device)
    got, err, plain_ms = compare_and_time(kernel, poseidon.poseidon_packed_plain, args, "poseidon",
                                          f"mixed block, {BLOCK_TXS:,} lanes")
    want = got.cpu().numpy()
    t0 = time.perf_counter()
    oracle = oracle_poseidon(pool, mixed)
    oracle_s = time.perf_counter() - t0
    bad = [i for i, d in enumerate(oracle) if bytes(want[i]) != d]
    if bad:
        raise AssertionError(f"poseidon kernel != host oracle on the mixed block, lanes {bad[:8]}")
    data, starts, lengths = args
    for n in (32, 132 * 32):  # other launch geometries: == the block's first lanes, so == plain
        if not np.array_equal(kernel(data, starts[:n], lengths[:n]).cpu().numpy(), want[:n]):
            raise AssertionError(f"poseidon kernel on the first {n:,} lanes != the same lanes of the block")
    order = torch.randperm(BLOCK_TXS, generator=torch.Generator().manual_seed(SEED)).to(device)
    shifted = torch.cat([torch.zeros(5, dtype=torch.uint8, device=device), data])
    for what, a, lanes in (
        ("shuffled starts", (data, starts[order].contiguous(), lengths[order].contiguous()), order.cpu().numpy()),
        ("starts 5 bytes off 16-byte alignment", (shifted, starts + 5, lengths), np.arange(BLOCK_TXS)),
    ):
        if not np.array_equal(kernel(*a).cpu().numpy(), want[lanes]):
            raise AssertionError(f"poseidon kernel on the mixed block, {what} != the same lanes in order")
    rows = np.random.default_rng(SEED + 13).integers(0, 256, (HASH_MIXED, 64), dtype=np.uint8)
    row_args = rows_as_packed(torch.from_numpy(rows).to(device))
    got_rows, row_err, _ = compare_and_time(kernel, poseidon.poseidon_packed_plain, row_args, "poseidon",
                                            f"[{HASH_MIXED}, 64] row block")
    if [bytes(d) for d in got_rows[:ORACLE_SAMPLE].cpu().numpy()] != oracle_poseidon(
            pool, [bytes(r) for r in rows[:ORACLE_SAMPLE]]):
        raise AssertionError("poseidon kernel != host oracle on the row block")
    log(f"[{card}] poseidon_packed == plain on every lane of the {BLOCK_TXS:,}-lane mixed block "
        f"(plain {plain_ms / 1e3:.1f} s; its first 32 and 4,224 lanes alone the same), == the host oracle on "
        f"its {len(mixed):,} distinct messages "
        f"({oracle_s:.1f} s in worker processes); shuffled and 5 bytes off alignment == the same lanes; "
        f"[{HASH_MIXED:,}, 64] rows == plain, the first {ORACLE_SAMPLE:,} == oracle")
    return max(err, row_err), plain_ms, args, tiled


def dag_rows(users, balances):
    """A DAG-transfer state's rows as the state plane hashes them, one row
    a user (numpy, in bulk): the key blobs flat(str "dag_transfer") ‖
    flat(bytes key), key = b"u%07d" (bench.py's userAdd names), [N, 28]
    uint8; and the leaf preimages, blob ‖ Entry.encode() of the row
    {"balance": 10 ASCII digits}, [N, 58] uint8 (codec/flat.py: u32
    little-endian lengths; Entry: status u8, field count u32, name, value)."""
    import struct

    import numpy as np

    def digits(v, width):  # zero-padded decimal ASCII, [N, width]
        places = 10 ** np.arange(width - 1, -1, -1)
        return (np.asarray(v, dtype=np.int64)[:, None] // places % 10 + 48).astype(np.uint8)

    n = len(users)
    head = np.frombuffer(struct.pack("<I", len(DAG_TABLE)) + DAG_TABLE + struct.pack("<I", 8) + b"u", np.uint8)
    blobs = np.concatenate([np.broadcast_to(head, (n, head.size)), digits(users, 7)], axis=1)
    entry = np.frombuffer(b"\x00" + struct.pack("<I", 1) + struct.pack("<I", 7) + b"balance" + struct.pack("<I", 10),
                          np.uint8)
    preimages = np.concatenate([blobs, np.broadcast_to(entry, (n, entry.size)), digits(balances, 10)], axis=1)
    return np.ascontiguousarray(blobs), np.ascontiguousarray(preimages)


def row_messages(*blocks) -> list[bytes]:
    """The rows of [N, L] uint8 arrays, as one list of messages."""
    return [bytes(r) for b in blocks for r in b]


def tree_levels(n: int, width: int = 16) -> int:
    """Launches of a tree of n leaves: one a level above the leaves."""
    from fisco_bcos_tpu_torch.ops.merkle import bucket_leaves

    m, k = bucket_leaves(n), 0
    while m > 1:
        m, k = -(-m // width), k + 1
    return k


def state_commitment(suite_, leaves, pages: list):
    """The commitment as StatePlane._page_root / _top_root build it, through
    the suite (its merkle_tree rides the DevicePlane): a tree a non-empty
    page over its leaves in key-blob order (`pages`: each page's user
    indices, in that order), 32 zero bytes for an empty page, then the top
    tree over the page roots. Returns (commitment, page trees, top tree)."""
    import numpy as np

    trees, roots = [], []
    for idx in pages:
        tree = suite_.merkle_tree(leaves[idx]) if len(idx) else None
        trees.append(tree)
        roots.append(tree.root if tree is not None else bytes(32))
    top = suite_.merkle_tree(np.frombuffer(b"".join(roots), dtype=np.uint8).reshape(-1, 32))
    return top.root, trees, top


def sampled_groups(trees, rng, per_level: int):
    """(group bytes, the kernel's digest of it) of up to `per_level` seeded
    groups of each level of `trees` (every group where a level has
    fewer), the short last groups included."""
    out = []
    depth = max(len(t.levels) for t in trees if t is not None)
    for k in range(depth - 1):
        groups = [(t, g) for t in trees if t is not None and k + 1 < len(t.levels)
                  for g in range(len(t.levels[k + 1]))]
        for t, g in rng.sample(groups, min(per_level, len(groups))):
            out.append((t.levels[k][16 * g : 16 * g + 16].tobytes(), bytes(t.levels[k + 1][g])))
    return out


def check_against_plain(card: str, device, pairs, what: str) -> float:
    """(message, the kernel's digest) pairs == the plain version on the card
    (one call over every message). Returns its ms."""
    import torch

    from fisco_bcos_tpu_torch.ops import poseidon
    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    t0 = time.perf_counter()
    plain = poseidon.poseidon_packed_plain(*upload_packed([m for m, _ in pairs], device)).cpu().numpy()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    bad = [i for i, (_, d) in enumerate(pairs) if bytes(plain[i]) != d]
    if bad:
        raise AssertionError(f"poseidon: the {what} != the plain version at sampled lanes {bad[:8]}")
    return ms


def check_tree_against_oracle(pool, tree, what: str) -> None:
    """Every level of `tree` and its bound root == the host oracle's, each
    level's groups hashed in worker processes."""
    from fisco_bcos_tpu_torch.crypto.ref.poseidon import poseidon_hash

    for k in range(len(tree.levels) - 1):
        level = tree.levels[k]
        groups = [level[g : g + 16].tobytes() for g in range(0, len(level), 16)]
        got = [bytes(d) for d in tree.levels[k + 1]]
        if oracle_poseidon(pool, groups) != got:
            raise AssertionError(f"poseidon: {what}, level {k + 1} != the host oracle")
    if tree.root != poseidon_hash(tree.padded_root + tree.n.to_bytes(8, "big")):
        raise AssertionError(f"poseidon: {what}'s bound root != the host oracle")


def run_state_commitment(card: str, device, pool) -> tuple[dict, list]:
    """The succinct state plane's commitment at its defaults, driven through
    the port's Poseidon suite as StatePlane._bootstrap and .preview drive
    theirs: 1,048,576 DAG-transfer keys in 64 pages (16,384 leaves a page)
    hashed in one hash_batch (the key blobs, then the leaf preimages), a
    page's user by H(blob)[:2] mod 64, a tree a page and the top tree; then
    one 10,240-transfer block's delta (20,480 keys: 40,960 messages) and the
    touched pages' trees and the top again. The bootstrap runs twice: the
    second counted (one launch for the leaves and one a tree level, no plain
    version) and equal to the first. Held against the plain version on the
    card at COMMIT_SAMPLE seeded lanes of every level (leaves, each page
    tree level, the top tree; bootstrap and delta; one plain call), and the
    first page's whole tree, both top trees and ORACLE_SAMPLE leaf messages
    against the host oracle. Returns the counted launches and the messages and
    digests of the delta's leaf batch (the timed leaf block)."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto import suite
    from fisco_bcos_tpu_torch.ops import _kernels

    poseidon_suite = suite.CryptoSuite(suite.Poseidon(device), suite.Secp256k1Crypto(device))
    rng = np.random.default_rng(SEED + 14)
    users = np.arange(STATE_KEYS)  # b"u%07d": blob order is user order
    balances = rng.integers(1_000_000_000, 2_000_000_000, STATE_KEYS)
    blobs, preimages = dag_rows(users, balances)
    t0 = time.perf_counter()
    msgs = row_messages(blobs, preimages)
    build_s = time.perf_counter() - t0

    def bootstrap():
        digests = poseidon_suite.hash_batch(msgs)
        page = (digests[:STATE_KEYS, 0].astype(np.int64) * 256 + digests[:STATE_KEYS, 1]) % STATE_PAGES
        order = np.argsort(page, kind="stable")
        pages = np.split(order, np.cumsum(np.bincount(page, minlength=STATE_PAGES))[:-1])
        leaves = np.ascontiguousarray(digests[STATE_KEYS:])
        return (digests, pages, leaves, *state_commitment(poseidon_suite, leaves, pages))

    t0 = time.perf_counter()
    digests, pages, leaves, commitment, trees, top = bootstrap()
    first_s = time.perf_counter() - t0
    expected = {"poseidon_packed": 1 + sum(tree_levels(len(p)) for p in pages if len(p)) + tree_levels(STATE_PAGES)}
    t0 = time.perf_counter()
    (digests2, _, _, commitment2, _, _), launches = counted_run(bootstrap, expected, "the state commitment")
    counted_s = time.perf_counter() - t0
    if commitment2 != commitment or not np.array_equal(digests2, digests):
        raise AssertionError("poseidon: a second state commitment over the same rows differs")

    # one block's delta: 10,240 transfers between 20,480 distinct users
    touched = rng.choice(STATE_KEYS, 2 * BLOCK_TXS, replace=False)
    amounts = rng.integers(1, 1000, BLOCK_TXS)
    new_bal = balances[touched].copy()
    new_bal[:BLOCK_TXS] -= amounts
    new_bal[BLOCK_TXS:] += amounts
    d_blobs, d_pre = dag_rows(touched, new_bal)
    d_msgs = row_messages(d_blobs, d_pre)
    drain_plane()
    before = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    d_digests = poseidon_suite.hash_batch(d_msgs)
    leaf_s = time.perf_counter() - t0
    if not np.array_equal(d_digests[: 2 * BLOCK_TXS], digests[touched]):
        raise AssertionError("poseidon: the delta's key blobs hash apart from the bootstrap's")
    new_leaves = leaves.copy()
    new_leaves[touched] = d_digests[2 * BLOCK_TXS :]
    page = (digests[touched, 0].astype(np.int64) * 256 + digests[touched, 1]) % STATE_PAGES
    dirty = sorted(set(page.tolist()))
    new_trees = list(trees)
    t1 = time.perf_counter()
    for pg in dirty:
        new_trees[pg] = poseidon_suite.merkle_tree(new_leaves[pages[pg]])
    trees_s = time.perf_counter() - t1
    roots = [t.root if t is not None else bytes(32) for t in new_trees]
    new_top = poseidon_suite.merkle_tree(np.frombuffer(b"".join(roots), dtype=np.uint8).reshape(-1, 32))
    delta_s = time.perf_counter() - t0
    drain_plane()
    delta_launches = _kernels.LAUNCHES["poseidon_packed"] - before["poseidon_packed"]
    want_launches = 1 + sum(tree_levels(len(pages[pg])) for pg in dirty) + tree_levels(STATE_PAGES)
    if delta_launches != want_launches:
        raise AssertionError(f"poseidon: the delta made {delta_launches} launches, not {want_launches}")
    if new_top.root == commitment:
        raise AssertionError("poseidon: the delta left the commitment unchanged")

    # held against the plain version (sampled lanes of every level) and the oracle
    pick = random.Random(SEED + 15)
    pairs = [(msgs[i], bytes(digests[i])) for i in pick.sample(range(2 * STATE_KEYS), 4 * COMMIT_SAMPLE)]
    pairs += [(d_msgs[i], bytes(d_digests[i])) for i in pick.sample(range(4 * BLOCK_TXS), COMMIT_SAMPLE)]
    for forest in (trees, [top], [new_trees[pg] for pg in dirty], [new_top]):
        pairs += sampled_groups(forest, pick, COMMIT_SAMPLE)
    plain_ms = check_against_plain(card, device, pairs, "state commitment")
    t0 = time.perf_counter()
    first = next(pg for pg in range(STATE_PAGES) if trees[pg] is not None)
    check_tree_against_oracle(pool, trees[first], f"page {first}'s tree")
    check_tree_against_oracle(pool, top, "the top tree")
    check_tree_against_oracle(pool, new_top, "the delta's top tree")
    sample = pick.sample(range(2 * STATE_KEYS), ORACLE_SAMPLE)
    if oracle_poseidon(pool, [msgs[i] for i in sample]) != [bytes(digests[i]) for i in sample]:
        raise AssertionError("poseidon: sampled leaf-batch digests != the host oracle")
    oracle_s = time.perf_counter() - t0
    sizes = [len(p) for p in pages]
    log(f"[{card}] state commitment (poseidon, {STATE_KEYS:,} DAG-transfer keys in {STATE_PAGES} pages of "
        f"{min(sizes):,}-{max(sizes):,} leaves): {first_s:.3f} s wall the first time, {counted_s:.3f} s counted "
        f"({launches['poseidon_packed']} launches: 1 leaf batch of {2 * STATE_KEYS:,} messages, one a tree "
        f"level), the rows' {2 * STATE_KEYS:,} messages built on the host in {build_s:.3f} s; one block's delta "
        f"({2 * BLOCK_TXS:,} keys, {4 * BLOCK_TXS:,} messages, {len(dirty)} pages touched): {delta_s:.3f} s wall "
        f"(the leaf batch {leaf_s:.3f} s, the page trees {trees_s:.3f} s), "
        f"{delta_launches} launches (1 leaf batch, one a tree level); "
        f"{len(pairs):,} sampled lanes of every level == plain ({plain_ms / 1e3:.1f} s); page {first}'s whole tree, "
        f"both top trees and {ORACLE_SAMPLE:,} leaf messages == host oracle ({oracle_s:.1f} s)")
    return launches, d_msgs


def poseidon_timed_blocks(device, mixed_args, mixed, leaf_msgs) -> dict:
    """Poseidon's timed blocks, what its callers send: the mixed block
    (hash_batch's messages of 0-700 bytes, 10,240 lanes); the state
    plane's leaf batch of one 10,240-transaction block (40,960 messages:
    20,480 key blobs, 20,480 leaf preimages); a merkle level of 10,240
    groups of 16 seeded nodes (512 bytes, 9 sponge blocks each). Each is
    (packed args on the card, the messages' lengths)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    nodes = np.random.default_rng(SEED + 16).integers(0, 256, (BLOCK_TXS * 16, 32), dtype=np.uint8)
    level = (torch.from_numpy(nodes).to(device).reshape(-1), torch.arange(BLOCK_TXS, device=device) * 512,
             torch.full((BLOCK_TXS,), 512, dtype=torch.int32, device=device))
    return {
        "mixed": (mixed_args, [len(m) for m in mixed]),
        "state plane leaf batch": (upload_packed(leaf_msgs, device), [len(m) for m in leaf_msgs]),
        "merkle level": (level, [512] * BLOCK_TXS),
    }


def measure_poseidon(card: str, device, blocks: dict) -> dict:
    """The kernel on each timed block at 32, 4,224 and all its lanes: a
    call (CUDA events) and the kernel alone (profiler), each beside its
    bound. Returns the mixed block's row at 10,240 lanes."""
    kernel = poseidon_kernel_fn(device)
    rows = {}
    for what, (args, lengths) in blocks.items():
        shown = []
        for n in (32, 132 * 32, len(lengths)):
            part = (args[0], args[1][:n], args[2][:n])
            row = poseidon_row(cuda_ms(lambda: kernel(*part), reps=3, inner=3), lengths[:n])
            row["device_ms"] = kernel_device_ms(lambda: kernel(*part), reps=5)
            shown.append(f"{n:,}: call {row['ms']:.4f} ms, alone {show_device_ms(row['device_ms'])}, "
                         f"bound {row['bound_ms']:.4f} ms ({row['ops']} multiplies), "
                         f"share {row['bound_ms'] / row['ms']:.3f}")
        log(f"[{card}] poseidon_packed on the {what} block: " + "; ".join(shown))
        rows[what] = row
    return rows["mixed"]


PAGE_TREE_LEAVES = 16_400  # a page of the state above (16,081-16,712 leaves): the 17,408-leaf bucket


def measure_page_tree(card: str, device) -> None:
    """One page tree at the 17,408-leaf bucket, as StatePlane.preview
    builds each touched page's: its wall time (host clock, median of 5)
    built directly (ops/merkle.py MerkleTree) and through the suite's
    merkle_tree (the DevicePlane's seam); each level's kernel time (a call
    by CUDA events, alone by the profiler) beside its bound and geometry;
    one 512-byte group alone (9 sponge blocks: a message's latency)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.crypto import suite
    from fisco_bcos_tpu_torch.ops import _kernels, merkle

    leaves = np.random.default_rng(SEED + 17).integers(0, 256, (PAGE_TREE_LEAVES, 32), dtype=np.uint8)
    poseidon_suite = suite.CryptoSuite(suite.Poseidon(device), suite.Secp256k1Crypto(device))
    direct_ms = host_ms(lambda: merkle.MerkleTree(leaves, hasher="poseidon", device=device), reps=5)
    suite_ms = host_ms(lambda: poseidon_suite.merkle_tree(leaves), reps=5)
    kernel = poseidon_kernel_fn(device)
    cur, _ = merkle._padded_leaves(leaves, 16, device)
    shown, total = [], 0.0
    while cur.shape[0] > 1:
        n = cur.shape[0]
        first = torch.arange(0, n, 16, device=device)
        args = (cur.reshape(-1), first * 32, ((n - first).clamp(max=16) * 32).to(torch.int32))
        row = poseidon_row(cuda_ms(lambda: kernel(*args)), args[2].tolist())
        alone = kernel_device_ms(lambda: kernel(*args), reps=5)
        total += row["ms"]
        shown.append(f"{args[1].shape[0]:,} groups: call {row['ms']:.4f} ms, alone {show_device_ms(alone)}, bound "
                     f"{row['bound_ms']:.4f} ms (share {row['bound_ms'] / row['ms']:.3f}), geometry "
                     f"{json.dumps(_kernels.geometry('poseidon', args[1].shape[0]))}")
        cur = kernel(*args)
    one = (cur.new_zeros(512), torch.zeros(1, dtype=torch.int64, device=device),
           torch.full((1,), 512, dtype=torch.int32, device=device))
    one_ms = cuda_ms(lambda: kernel(*one))
    one_alone = kernel_device_ms(lambda: kernel(*one), reps=5)
    per_block = "not measured" if one_alone is None else f"{one_alone[0] / 9:.4f} ms"
    log(f"[{card}] poseidon page tree of {PAGE_TREE_LEAVES:,} leaves ({merkle.bucket_leaves(PAGE_TREE_LEAVES):,} "
        f"bucketed): {direct_ms:.3f} ms wall direct, {suite_ms:.3f} ms through the suite; levels: "
        + "; ".join(shown) + f" ({total:.4f} ms of calls); one 512-byte group alone: call {one_ms:.4f} ms, "
        f"alone {show_device_ms(one_alone)}, {per_block} a sponge block")


def run_poseidon_phase(card: str, device) -> tuple[dict, dict]:
    """Poseidon: the mixed block (check_poseidon_block), the succinct state
    plane's commitment (run_state_commitment), the timed blocks, a page
    tree; returns the kernel's row (its launches: the counted
    commitment's) and the timed blocks."""
    from fisco_bcos_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    with oracle_pool() as pool:
        err, plain_ms, mixed_args, mixed = check_poseidon_block(card, device, pool)
        launches, leaf_msgs = run_state_commitment(card, device, pool)
    blocks = poseidon_timed_blocks(device, mixed_args, mixed, leaf_msgs)
    row = measure_poseidon(card, device, blocks)
    measure_page_tree(card, device)
    row.update(max_abs_err=err, plain_ms=plain_ms, launches=launches["poseidon_packed"])
    geometry = _kernels.geometry("poseidon", BLOCK_TXS)
    log(f"[{card}] poseidon phase: {time.perf_counter() - t0:.1f} s; launch geometry at {BLOCK_TXS:,} lanes "
        f"{json.dumps(geometry)}; {POSEIDON_BLOCK_MULS:,} multiplies a sponge block "
        f"({POSEIDON_PERM_MULS:,} the permutation, the two elements' encoding counted)")
    return row, blocks


# ---------------------------------------------------------------------------
# BLS12-381: the aggregate-QC pairing check
# ---------------------------------------------------------------------------

BLS_LANES = (1, 4, 64, 1024)  # QC checks a call: one certificate up to a burst of them
BLS_REPLACES = "fisco_bcos_tpu/ops/bls12_381.py:591"
BLS_LAUNCHES = {"bls12_381_pairing": 1}


def make_bls_checks(seed: int) -> list[tuple[str, tuple]]:
    """(kind, (pubs, msg, agg_sig)) of every lane kind of the aggregate
    check, from a seeded 8-member committee: a quorum of 6, a single signer
    and the whole committee on a second message, which pass; an apk with one
    extra signer or one missing, a signature over the wrong message, another
    quorum's signature, a malformed key and an empty signer set (no apk), a
    malformed signature and one outside the subgroup (no σ), which fail."""
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref

    rng = random.Random(seed)
    keys = [ref.keygen(rng.getrandbits(256)) for _ in range(8)]
    pubs = [pk for _, pk in keys]
    msg, other = rng.randbytes(32), rng.randbytes(32)

    def agg(ids, m):
        return ref.aggregate_signatures([ref.sign(keys[i][0], m) for i in ids])

    quorum = agg(range(6), msg)
    # a twist point outside the r-torsion, compressed: decompression rejects it
    x = next((k, 0) for k in range(1, 100)
             if ref.f2_sqrt(ref.f2_add(ref.f2_mul(ref.f2_sqr((k, 0)), (k, 0)), ref.XI_B)) is not None)
    off_group = bytes([0x80 | x[1].to_bytes(48, "big")[0]]) + x[1].to_bytes(48, "big")[1:] + x[0].to_bytes(48, "big")
    return [
        ("a quorum of 6", (tuple(pubs[:6]), msg, quorum)),
        ("a single signer", ((pubs[7],), msg, agg([7], msg))),
        ("the whole committee", (tuple(pubs), other, agg(range(8), other))),
        ("an apk with one extra signer", (tuple(pubs[:7]), msg, quorum)),
        ("an apk missing a signer", (tuple(pubs[:5]), msg, quorum)),
        ("a signature on the wrong message", (tuple(pubs[:6]), msg, agg(range(6), other))),
        ("another quorum's signature", (tuple(pubs[2:8]), msg, quorum)),
        ("a malformed key", ((pubs[0], b"\x00" * 48), msg, quorum)),
        ("an empty signer set", ((), msg, quorum)),
        ("a malformed signature", (tuple(pubs[:6]), msg, b"\x00" * 96)),
        ("a signature outside the subgroup", (tuple(pubs[:6]), msg, off_group)),
    ]


def bls_triples(checks) -> list[tuple]:
    """Each check's decoded (apk, σ, H(m)), as BLSCrypto decodes it (None
    where a point does not decode)."""
    from fisco_bcos_tpu_torch.crypto import bls
    from fisco_bcos_tpu_torch.ops import bls12_381

    out = []
    for pubs, msg, agg in checks:
        apk = bls._apk_point(tuple(pubs)) if pubs else None
        sig = bls._g2_point(agg)
        out.append((apk, sig, bls12_381.hash_to_g2(msg) if apk is not None and sig is not None else None))
    return out


def bls_oracle(triples) -> tuple[list[bool], list[tuple], float]:
    """The oracle's verdict and GT element a lane (on the substitutes where
    a point is None), and its host ms for one check."""
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref
    from fisco_bcos_tpu_torch.ops import bls12_381

    bits = list(bls12_381.host_pairing_check_batch(triples))
    gts, one_ms = [], None
    for apk, sig, hm in triples:
        if apk is None or sig is None or hm is None:
            apk, sig, hm = bls12_381._SUB_APK, bls12_381._SUB_SIG, bls12_381._SUB_HM
        t0 = time.perf_counter()
        gts.append(ref.final_exponentiation(ref.miller_loop([(ref.ec_neg(ref.G1, ref.FP_OPS), sig), (apk, hm)])))
        one_ms = one_ms or (time.perf_counter() - t0) * 1e3
    return bits, gts, one_ms


def check_bls_block(card: str, device, rows, valid, want, want_gt) -> tuple[int, float]:
    """The kernel and the plain version on the same rows on the card: equal
    bits and GT elements on every lane, and the oracle's on every lane
    (lane i holds case i % cases). Returns (largest limb difference, plain
    ms)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels, bls12_381

    n, cases = rows.shape[0], len(want)
    ok, gt = _kernels.bls12_381_pairing_check(rows, bls12_381.kernel_table(device), gt=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gt_plain = bls12_381.pairing_gt_plain(rows)
    ok_plain = bls12_381.f12_eq_one(gt_plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    limbs = bls12_381.words_to_limbs(gt)
    err = int((limbs - gt_plain).abs().max())
    if err or not torch.equal(ok, ok_plain):
        raise AssertionError(f"bls12_381_pairing != its plain version on the BLS mixed block ({err})")
    lanes = np.arange(n) % cases
    if list(ok.cpu().numpy() & valid) != [want[i] for i in lanes]:
        raise AssertionError("bls12_381_pairing's verdicts != the host oracle's on the BLS mixed block")
    distinct = bls12_381.tower_to_ref(limbs[: min(n, cases)])
    tiled = torch.equal(limbs, limbs[:cases].repeat((n + cases - 1) // cases, 1, 1)[:n]) if n > cases else True
    if distinct != want_gt[: len(distinct)] or not tiled:
        raise AssertionError("bls12_381_pairing's GT elements != the host oracle's on the BLS mixed block")
    log(f"[{card}] BLS mixed block, {n:,} lanes of {cases} cases ({int((ok.cpu().numpy() & valid).sum())} ok): "
        f"the pairing kernel == its plain version (verdicts and GT elements, every lane) == the host oracle; "
        f"plain {plain_ms:.1f} ms")
    return err, plain_ms


def bls_against_parent(card: str, parent, rows, table, crypto, qc: tuple) -> None:
    """In turns parent, new, new, parent: the pairing kernel against the
    parent checkout's (built from that checkout's sources) at each of
    BLS_LANES (CUDA events; equal verdicts on every lane), then one
    BLSCrypto.aggregate_verify with each checkout's kernel patched into
    _kernels.bls12_381_pairing_check (host clock a call, synchronised)."""
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels

    new, old = _kernels.bls12_381_pairing_check, parent.bls12_381_pairing_check
    if not torch.equal(new(rows, table), old(rows, table)):
        raise AssertionError("bls12_381_pairing != the parent checkout's kernel on the BLS mixed block")
    for m in BLS_LANES:
        t = [cuda_ms(lambda f=f: f(rows[:m], table), reps=3, inner=1) for f in (old, new, new, old)]
        log(f"[{card}] bls12_381_pairing @ {m:,} lanes against the parent checkout (equal on every lane): "
            f"parent {t[0]:.4f}, new {t[1]:.4f}, new {t[2]:.4f}, parent {t[3]:.4f} ms "
            f"(new/parent {(t[1] + t[2]) / (t[0] + t[3]):.4f})")

    def qc_ms(fn) -> float:
        _kernels.bls12_381_pairing_check = fn
        try:
            if crypto.aggregate_verify(*qc) is not True:
                raise AssertionError("BLSCrypto.aggregate_verify rejected a valid quorum")
            return host_ms(lambda: crypto.aggregate_verify(*qc), reps=5)
        finally:
            _kernels.bls12_381_pairing_check = new

    t = [qc_ms(f) for f in (old, new, new, old)]
    log(f"[{card}] BLSCrypto.aggregate_verify, one QC, against the parent checkout's kernel: parent "
        f"{t[0]:.3f}, new {t[1]:.3f}, new {t[2]:.3f}, parent {t[3]:.3f} ms")


def bls_latency_floor(card: str, bench: dict, one_lane_ms: float, bound_ms: float) -> None:
    """The one-warp latency floor of a check: the programs' rows (each on
    the critical path: a row waits for the one before) at the field bench's
    cycles a row of 32 products and of 32 sums, and the inversion's, at
    1,980 MHz; beside the bound and the kernel's time at one lane."""
    from fisco_bcos_tpu_torch.ops import bls12_381_programs

    rows = bls12_381_programs.critical_rows()
    cycles = (rows["mul"] * bench[BLS_BENCH_ROW] + rows["addsub"] * bench[BLS_BENCH_SUM_ROW]
              + rows["inversions"] * bench[BLS_BENCH_INV])
    floor = cycles / 1980e3
    log(f"[{card}] bls12_381_pairing one-warp latency floor at one lane: {rows['mul']:,} rows of products x "
        f"{bench[BLS_BENCH_ROW]:.1f} + {rows['addsub']:,} rows of sums x {bench[BLS_BENCH_SUM_ROW]:.1f} + "
        f"{rows['inversions']} inversion x {bench[BLS_BENCH_INV]:.1f} cycles = {cycles:,.0f} cycles, {floor:.4f} ms "
        f"at 1,980 MHz, beside the bound's {bound_ms:.4f} ms; the kernel {one_lane_ms:.4f} ms "
        f"({floor / one_lane_ms:.1%} of it)")


def run_bls_phase(card: str, device, parent=None) -> dict:
    """BLS12-381 (ROADMAP A7, B4(c)): the pairing kernel against its plain
    version and the oracle on the mixed block; BLSCrypto.aggregate_verify_batch,
    the QC check's path, counted; the kernel alone, pairing_check_batch, the
    QC check (through the plane and direct, in turns) and the plain version
    at each of BLS_LANES, beside the bound; with `parent`, the kernel and a
    QC check in turns with the parent checkout's kernel. Returns the
    kernel's row (with `one_lane_ms`)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.crypto import bls
    from fisco_bcos_tpu_torch.ops import _kernels, bls12_381

    t0 = time.perf_counter()
    named = make_bls_checks(SEED + 7)
    checks = [c for _, c in named]
    triples = bls_triples(checks)
    want, want_gt, oracle_ms = bls_oracle(triples)
    log(f"BLS: {len(checks)} aggregate-check cases ({sum(want)} pass: "
        f"{', '.join(k for (k, _), w in zip(named, want) if w)}), the oracle's verdicts and GT elements in "
        f"{time.perf_counter() - t0:.1f} s on the host; one check {oracle_ms:.1f} ms")
    n = max(BLS_LANES)
    lanes = np.arange(n) % len(checks)
    rows_np, valid = bls12_381.device_inputs(triples)
    rows = torch.from_numpy(rows_np[lanes]).to(device)
    err, _ = check_bls_block(card, device, rows, valid[lanes], want, want_gt)

    crypto = bls.BLSCrypto(device)
    tiled = [checks[i] for i in lanes]
    got, launches = counted_run(lambda: crypto.aggregate_verify_batch(tiled), BLS_LAUNCHES,
                                f"BLSCrypto.aggregate_verify_batch at {n:,} lanes")
    if list(got) != [want[i] for i in lanes]:
        raise AssertionError("BLSCrypto.aggregate_verify_batch != the host oracle")
    if crypto.aggregate_verify(*checks[0]) is not True:
        raise AssertionError("BLSCrypto.aggregate_verify rejected a valid quorum")
    log(f"[{card}] BLSCrypto.aggregate_verify_batch at {n:,} lanes == the host oracle; launches "
        + show_launches(launches))

    table = bls12_381.kernel_table(device)
    tiled_triples = [triples[i] for i in lanes]
    times = {}
    for m in BLS_LANES:
        kernel_ms = cuda_ms(lambda: _kernels.bls12_381_pairing_check(rows[:m], table), reps=3, inner=2)
        batch_ms = host_ms(lambda: bls12_381.pairing_check_batch(tiled_triples[:m], device))
        qc = plane_and_direct_ms(lambda: crypto.aggregate_verify_batch(tiled[:m]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bls12_381.pairing_check_plain(rows[:m])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        bound = kernel_row("bls12_381_pairing", "", "", kernel_ms, m * BLS_PAIRING_MULS,
                           io_bytes=m * (4 * _kernels.BLS_ROW_WORDS + 1) + 4 * _kernels.BLS_TABLE_WORDS)["bound_ms"]
        times[m] = (kernel_ms, plain_ms, bound)
        log(f"[{card}] bls12_381_pairing @ {m:,} lanes: kernel alone {kernel_ms:.4f} ms (bound {bound:.4f}, "
            f"{bound / kernel_ms:.2%}), pairing_check_batch {batch_ms:.3f} ms, BLSCrypto.aggregate_verify_batch "
            f"{show_turns([qc])}, plain {plain_ms:.1f} ms; the host oracle {oracle_ms:.1f} ms a check")
    qc_one = plane_and_direct_ms(lambda: crypto.aggregate_verify(*checks[0]))
    log(f"[{card}] BLSCrypto.aggregate_verify, one QC (a quorum of 6): {show_turns([qc_one])} ms")
    if parent and hasattr(parent, "bls12_381_pairing_check"):
        bls_against_parent(card, parent, rows, table, crypto, checks[0])
    kernel_ms, plain_ms, _ = times[n]
    row = kernel_row("bls12_381_pairing", "fisco_bcos_tpu_torch/csrc/bls12_381.cu", BLS_REPLACES, kernel_ms,
                     n * BLS_PAIRING_MULS,
                     io_bytes=n * (4 * _kernels.BLS_ROW_WORDS + 1) + 4 * _kernels.BLS_TABLE_WORDS)
    row.update(launches=launches["bls12_381_pairing"], max_abs_err=err, plain_ms=plain_ms, lanes=n,
               one_lane_ms=times[min(BLS_LANES)][0], one_lane_bound_ms=times[min(BLS_LANES)][2])
    log(f"[{card}] bls phase: {time.perf_counter() - t0:.1f} s; launch geometry at {n:,} lanes "
        f"{json.dumps(_kernels.geometry('bls12_381', n))}; the bound's least work {BLS_PAIRING_MULS:,} multiplies "
        f"a check ({BLS_LEAST_PRODUCTS:,} Fp products and an Fp inversion); the kernel makes {BLS_FP_PRODUCTS:,} "
        f"Fp products a check, {BLS_FP_SQUARINGS} of them squarings")
    return row


# ---------------------------------------------------------------------------
# BLS12-381: the multi-pairing, header sync's one aggregate check
# ---------------------------------------------------------------------------

MULTI_PAIRS = (2, 9, 65, 129, 257)  # timed: one check's pairs up to a 256-header fold
HEADER_CHUNK = 64  # FISCO_SYNC_HEADER_BATCH's default: a chunk of 64 headers folds into 65 pairs
PLAIN_PAIRS = (1, 2, HEADER_CHUNK + 1)  # pair counts also held against the plain version (~3-4 s a call)
MULTI_REPLACES = "fisco_bcos_tpu/ops/bls12_381.py:599"
MULTI_LAUNCHES = {"bls12_381_multi_pairing": 1}


def make_header_checks(n: int, seed: int) -> tuple[list[tuple], float]:
    """n header checks as a light client's sync folds them: a seeded
    8-member committee's quorum of 6 signs n distinct 32-byte header hashes
    (pubs, msg, agg_sig), the aggregate signature made as (Σ sk)·H(m).
    Returns them and the host ms of hash_to_g2 a header, uncached (the
    first hash of each new header)."""
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref

    rng = random.Random(seed)
    keys = [ref.keygen(rng.getrandbits(256)) for _ in range(8)]
    pubs = tuple(pk for _, pk in keys[:6])
    sk = sum(s for s, _ in keys[:6]) % ref.R_ORDER
    checks, hash_s = [], 0.0
    for _ in range(n):
        msg = rng.randbytes(32)
        t0 = time.perf_counter()
        hm = ref.hash_to_g2(msg)
        hash_s += time.perf_counter() - t0
        checks.append((pubs, msg, ref.compress_g2(ref.ec_mul(hm, sk, ref.FP2_OPS))))
    return checks, hash_s * 1e3 / n


def oracle_multi_gt(pairs) -> tuple:
    """The oracle's GT element of a multi-pairing: final_exponentiation of
    the Miller product of the live pairs (a pool worker's task)."""
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref

    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    return ref.final_exponentiation(ref.miller_loop(live))


def multi_cases(named, headers) -> list[tuple[str, list]]:
    """(what, pairs) of the multi-pairing's correctness lists, from the BLS
    phase's checks and the header chunk: one pair; one check's two pairs,
    accepted and rejected; folds of two checks (3 pairs), accepted,
    rejected, and accepted with None pairs among them; the 64-header chunk
    (65 pairs), accepted and with one header's signature swapped for the
    next header's; 8 headers (9 pairs: 5 groups, odd at two levels of the
    kernel's product tree); 128 headers (129 pairs)."""
    from fisco_bcos_tpu_torch.crypto import bls
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref

    c = dict(named)
    pairs = bls.multi_pairing_pairs
    one_check = pairs([c["a quorum of 6"]])
    good3 = pairs([c["a quorum of 6"], c["a single signer"]])
    i = len(headers) // 4
    swapped = headers[:i] + [(headers[i][0], headers[i][1], headers[i + 1][2])] + headers[i + 1:]
    return [
        ("one pair", one_check[:1]),
        ("a quorum's check", one_check),
        ("an apk with one extra signer", pairs([c["an apk with one extra signer"]])),
        ("a fold of two checks", good3),
        ("a fold with the wrong message", pairs([c["a quorum of 6"], c["a signature on the wrong message"]])),
        ("the fold with None pairs", [(None, ref.G2)] + good3[:2] + [(ref.G1, None)] + good3[2:]),
        (f"{HEADER_CHUNK} headers", pairs(headers)),
        (f"{HEADER_CHUNK} headers, one signature swapped", pairs(swapped)),
        ("8 headers", pairs(headers[:8])),
        (f"{2 * HEADER_CHUNK} headers", pairs(headers + headers)),
    ]


def check_multi_pairings(card: str, device, cases, pool) -> tuple[int, dict]:
    """Each list: the kernel's verdict and GT element against the plain
    version's on the card (the first list of each of PLAIN_PAIRS) and the
    oracle's, and multi_pairing_check's verdict. Returns (the largest limb
    difference, the plain version's ms by pair count)."""
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels, bls12_381

    table = bls12_381.kernel_table(device)
    want = list(pool.map(oracle_multi_gt, [pairs for _, pairs in cases]))
    err, plain_ms = 0, {}
    for (what, pairs), want_gt in zip(cases, want):
        rows = torch.from_numpy(bls12_381.multi_pairing_rows(pairs)).to(device)
        k = rows.shape[0]
        ok, gt = _kernels.bls12_381_multi_pairing(rows, table, gt=True)
        limbs = bls12_381.words_to_limbs(gt)
        against_plain = k in PLAIN_PAIRS and k not in plain_ms
        if against_plain:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gt_plain = bls12_381.multi_pairing_gt_plain(rows)
            torch.cuda.synchronize()
            plain_ms[k] = (time.perf_counter() - t0) * 1e3
            err = max(err, int((limbs - gt_plain).abs().max()))
            if err or bool(ok[0]) != bool(bls12_381.f12_eq_one(gt_plain)[0]):
                raise AssertionError(f"bls12_381_multi_pairing != its plain version on {what} ({err})")
        verdict = want_gt == (1,) + (0,) * 11
        if bls12_381.tower_to_ref(limbs) != [want_gt] or bool(ok[0]) != verdict:
            raise AssertionError(f"bls12_381_multi_pairing != the host oracle on {what}")
        if bls12_381.multi_pairing_check(pairs, device) != verdict:
            raise AssertionError(f"multi_pairing_check != the host oracle on {what}")
        log(f"[{card}] multi-pairing, {what}: {k} pairs, {'accepted' if verdict else 'rejected'}; the kernel == "
            + ("its plain version (verdict and GT element) == " if against_plain else "")
            + "the host oracle (verdict and GT element); multi_pairing_check's verdict the same")
    return err, plain_ms


def multi_verify_stages(card: str, device, crypto, checks, hash_ms: float) -> None:
    """BLSCrypto.multi_pairing_verify of a header chunk by stages (host
    clock, median of 3, each synchronised; decode and the scalar
    multiplications, ~a second of host work, one call each): decode
    (signatures uncached, the committee's keys cached), hash_to_g2
    (uncached: timed as the headers were made; cached), the scalar
    multiplications and the fold, rows, upload, the kernel with its
    download; then the whole call in turns with aggregate_verify_batch of
    the same checks (the plane's default path)."""
    import torch

    from fisco_bcos_tpu_torch.crypto import bls
    from fisco_bcos_tpu_torch.ops import _kernels, bls12_381

    triples = [(bls._apk_point(p), bls._g2_point(s), bls12_381.hash_to_g2(m)) for p, m, s in checks]
    pairs = bls.rlc_pairs(checks, triples)
    rows_np = bls12_381.multi_pairing_rows(pairs)
    rows = torch.from_numpy(rows_np).to(device)
    table = bls12_381.kernel_table(device)
    def once_ms(fn) -> float:  # a host stage of ~a second: one call
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    stages = {
        "decode": once_ms(lambda: [(bls._apk_point(p), bls._g2_point.__wrapped__(s)) for p, _, s in checks]),
        "hash_to_g2 uncached": hash_ms * len(checks),
        "hash_to_g2 cached": host_ms(lambda: [bls12_381.hash_to_g2(m) for _, m, _ in checks]),
        "scalar multiplications": once_ms(lambda: bls.rlc_pairs(checks, triples)),
        "rows": host_ms(lambda: bls12_381.multi_pairing_rows(pairs)),
        "upload": host_ms(lambda: torch.from_numpy(rows_np).to(device)),
        "kernel and download": host_ms(lambda: _kernels.bls12_381_multi_pairing(rows, table).cpu()),
    }
    log(f"[{card}] BLSCrypto.multi_pairing_verify, {len(checks)} headers ({rows.shape[0]} pairs), stages (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    multi = lambda: crypto.multi_pairing_verify(checks)  # noqa: E731
    batch = lambda: crypto.aggregate_verify_batch(checks)  # noqa: E731
    t = [host_ms(f) for f in (multi, batch, batch, multi)]
    log(f"[{card}] {len(checks)} headers, in turns: multi_pairing_verify {t[0]:.3f} / {t[3]:.3f} ms, "
        f"aggregate_verify_batch {t[1]:.3f} / {t[2]:.3f} ms (the same checks, hash_to_g2 and decode cached)")


def multi_against_parent(card: str, parent, rows, table, crypto, headers) -> None:
    """In turns parent, new, new, parent: the multi-pairing kernel against
    the parent checkout's (built from that checkout's sources) at each of
    MULTI_PAIRS (CUDA events; equal verdicts and GT elements), then
    BLSCrypto.multi_pairing_verify of the header chunk with each checkout's
    kernel patched into _kernels.bls12_381_multi_pairing (host clock,
    synchronised; hash_to_g2 and decode cached)."""
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels

    new, old = _kernels.bls12_381_multi_pairing, parent.bls12_381_multi_pairing
    for k in MULTI_PAIRS:
        got, want = new(rows[:k], table, gt=True), old(rows[:k], table, gt=True)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"bls12_381_multi_pairing != the parent checkout's kernel at {k} pairs")
        t = [cuda_ms(lambda f=f: f(rows[:k], table), reps=3, inner=2) for f in (old, new, new, old)]
        log(f"[{card}] bls12_381_multi_pairing @ {k} pairs against the parent checkout (equal verdict and GT "
            f"element): parent {t[0]:.4f}, new {t[1]:.4f}, new {t[2]:.4f}, parent {t[3]:.4f} ms "
            f"(new/parent {(t[1] + t[2]) / (t[0] + t[3]):.4f})")

    def verify_ms(fn) -> float:
        _kernels.bls12_381_multi_pairing = fn
        try:
            if crypto.multi_pairing_verify(headers) is not True:
                raise AssertionError("BLSCrypto.multi_pairing_verify rejected the header chunk")
            return host_ms(lambda: crypto.multi_pairing_verify(headers))
        finally:
            _kernels.bls12_381_multi_pairing = new

    t = [verify_ms(f) for f in (old, new, new, old)]
    log(f"[{card}] BLSCrypto.multi_pairing_verify, {len(headers)} headers, against the parent checkout's kernel: "
        f"parent {t[0]:.3f}, new {t[1]:.3f}, new {t[2]:.3f}, parent {t[3]:.3f} ms")


def run_multi_pairing_phase(card: str, device, parent=None) -> dict:
    """BLS12-381's multi-pairing (ROADMAP A7b): the kernel against its plain
    version and the oracle on every list of multi_cases; a list of only None
    pairs (no launch); BLSCrypto.multi_pairing_verify of a 64-header chunk,
    the header sync's path, counted, accepted, and rejected with one
    signature swapped; the kernel alone and multi_pairing_check at each of
    MULTI_PAIRS beside the bound; the chunk's stages, and the call in turns
    with aggregate_verify_batch; with `parent`, the kernel and the chunk's
    multi_pairing_verify in turns with the parent checkout's kernel.
    Returns the kernel's row (with `times`)."""
    import torch

    from fisco_bcos_tpu_torch.crypto import bls
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref
    from fisco_bcos_tpu_torch.ops import _kernels, bls12_381, bls12_381_programs

    t0 = time.perf_counter()
    named = make_bls_checks(SEED + 7)
    headers, hash_ms = make_header_checks(HEADER_CHUNK, SEED + 11)
    cases = multi_cases(named, headers)
    log(f"multi-pairing: {len(cases)} lists and {HEADER_CHUNK} header checks built on the host in "
        f"{time.perf_counter() - t0:.1f} s (hash_to_g2 {hash_ms:.1f} ms a new header)")
    with oracle_pool() as pool:
        err, plain_ms = check_multi_pairings(card, device, cases, pool)
    crypto = bls.BLSCrypto(device)
    ok, launches = counted_run(lambda: crypto.multi_pairing_verify(headers), MULTI_LAUNCHES,
                               f"BLSCrypto.multi_pairing_verify of {HEADER_CHUNK} headers")
    swapped = headers[:1] + [(headers[1][0], headers[1][1], headers[2][2])] + headers[2:]
    bad, _ = counted_run(lambda: crypto.multi_pairing_verify(swapped), MULTI_LAUNCHES,
                         f"BLSCrypto.multi_pairing_verify of {HEADER_CHUNK} headers, one signature swapped")
    none, _ = counted_run(lambda: bls12_381.multi_pairing_check([(None, ref.G2), (ref.G1, None)], device), {},
                          "multi_pairing_check of only None pairs")
    if ok is not True or bad is not False or none is not True:
        raise AssertionError(f"multi_pairing_verify / multi_pairing_check: {ok}, {bad}, {none}")
    log(f"[{card}] BLSCrypto.multi_pairing_verify of {HEADER_CHUNK} headers accepted, with one signature swapped "
        f"rejected; launches {show_launches(launches)}; only None pairs: True, no launch")

    pairs = bls.multi_pairing_pairs(headers * 4)  # 257 pairs, the timed lists' prefixes
    rows = torch.from_numpy(bls12_381.multi_pairing_rows(pairs)).to(device)
    table = bls12_381.kernel_table(device)
    times = {}
    for k in MULTI_PAIRS:
        kernel_ms = cuda_ms(lambda: _kernels.bls12_381_multi_pairing(rows[:k], table), reps=3, inner=2)
        check_ms = host_ms(lambda: bls12_381.multi_pairing_check(pairs[:k], device))
        row = kernel_row("bls12_381_multi_pairing", "", "", kernel_ms, bls_multi_muls(k),
                         io_bytes=k * 4 * _kernels.BLS_PAIR_WORDS + 1 + 4 * _kernels.BLS_TABLE_WORDS)
        times[k] = (kernel_ms, row["bound_ms"])
        log(f"[{card}] bls12_381_multi_pairing @ {k} pairs: kernel alone {kernel_ms:.4f} ms (bound "
            f"{row['bound_ms']:.4f}, {row['bound_ms'] / kernel_ms:.2%}; {bls_multi_least_products(k):,} Fp "
            f"products of the least work), multi_pairing_check {check_ms:.3f} ms")
    multi_verify_stages(card, device, crypto, headers, hash_ms)
    if parent and hasattr(parent, "bls12_381_multi_pairing"):
        multi_against_parent(card, parent, rows, table, crypto, headers)
    k = HEADER_CHUNK + 1
    row = kernel_row("bls12_381_multi_pairing", "fisco_bcos_tpu_torch/csrc/bls12_381.cu", MULTI_REPLACES,
                     times[k][0], bls_multi_muls(k),
                     io_bytes=k * 4 * _kernels.BLS_PAIR_WORDS + 1 + 4 * _kernels.BLS_TABLE_WORDS)
    row.update(launches=launches["bls12_381_multi_pairing"], max_abs_err=err, plain_ms=plain_ms[k], lanes=k,
               times=times)
    log(f"[{card}] multi-pairing phase: {time.perf_counter() - t0:.1f} s; the plain version "
        + ", ".join(f"{n} pairs {ms:.1f} ms" for n, ms in sorted(plain_ms.items()))
        + f"; geometry at {k} pairs: one launch of {(k + 1) // 2} blocks of 128 threads (a group of two pairs "
        f"each, a quad of lanes an Fp product; the groups' f values meet by a tree of products "
        f"{bls12_381_programs.tree_depth((k + 1) // 2)} deep), 42,080 B dynamic shared each (12,768 B of slots, "
        f"29,312 B of the programs' tables)")
    return row


def bls_multi_latency_floor(card: str, bench: dict, times: dict) -> None:
    """The latency floor of a K-pair multi-pairing on its groups of four
    warps: the rows on its critical path (one group's Miller loop, the
    tree's depth in products, the final exponentiation) at the field
    bench's cycles a row in the kernel's forms (a row of 32 quad products,
    a row of 32 quad sums, a block sync each) and the inversion's, at 1,980
    MHz, beside the kernel and the bound at each of MULTI_PAIRS."""
    from fisco_bcos_tpu_torch.ops import bls12_381_programs

    for k, (kernel_ms, bound_ms) in times.items():
        rows = bls12_381_programs.multi_critical_rows(k)
        mul, add = rows["mul"] * bench[BLS_BENCH_QUAD_ROW], rows["addsub"] * bench[BLS_BENCH_QUAD_SUM_ROW]
        cycles = mul + add + rows["inversions"] * bench[BLS_BENCH_INV]
        floor = cycles / 1980e3
        log(f"[{card}] bls12_381_multi_pairing latency floor @ {k} pairs: {rows['mul']:,} rows of products x "
            f"{bench[BLS_BENCH_QUAD_ROW]:.1f} cycles ({mul / 1980e3:.4f} ms), {rows['addsub']:,} of sums x "
            f"{bench[BLS_BENCH_QUAD_SUM_ROW]:.1f} ({add / 1980e3:.4f} ms), {rows['inversions']} inversion: "
            f"{cycles:,.0f} cycles, {floor:.4f} ms at 1,980 MHz (sums {add / cycles:.1%} of it), beside the "
            f"bound's {bound_ms:.4f} ms; the kernel {kernel_ms:.4f} ms ({floor / kernel_ms:.1%} of it)")


# ---------------------------------------------------------------------------
# The DevicePlane: merged seams, the window, concurrent callers, lanes
# ---------------------------------------------------------------------------

PLANE_RAGGED = (1, 4, 7, 100, 1000)  # callers' sizes, merged into one dispatch
PLANE_WINDOWS_MS = (0.0, 0.25, 0.5, 1.0, 2.0)
PLANE_CALLERS = (4, 16, 64)
PLANE_CONCURRENT_WINDOWS_MS = (0.0, 2.0)
PLANE_SMALL_ADMISSIONS = 64  # queued behind a 10,240-tx admit_batch under load
PLANE_ANATOMY_CALLS = 9  # lone QC checks a window, timed by segment
STARVED_MS, STARVED_AGE_MS = 20.0, 30.0  # the starvation case: its rule, and the small admissions' extra age
STREAM_SLEEP_CYCLES = 60_000_000  # ~30 ms of the worker's stream asleep before a launch
_TIMED_PLANE = None


def timed_plane_class():
    """The DevicePlane with each dispatch recorded in `releases`: the
    thread that ran it, the op, each request's lane and age at release (ms),
    the release's lag past the oldest request's window deadline (ms), the
    oldest request's enqueue time and the dispatch's start and end (the
    perf_counter clock)."""
    global _TIMED_PLANE
    if _TIMED_PLANE is None:
        from fisco_bcos_tpu_torch.device.plane import DevicePlane

        class TimedPlane(DevicePlane):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.releases: list[dict] = []

            def _dispatch(self, op, reqs):
                start = time.perf_counter()
                try:
                    super()._dispatch(op, reqs)
                finally:
                    self.releases.append({
                        "thread": threading.current_thread().name, "op": op,
                        "ages_ms": [(r.lane, (start - r.t_enq) * 1e3) for r in reqs],
                        "lag_ms": (start - reqs[0].t_enq) * 1e3 - self.window_ms,
                        "t_enq": reqs[0].t_enq, "start": start, "end": time.perf_counter(),
                    })

        _TIMED_PLANE = TimedPlane
    return _TIMED_PLANE


@contextlib.contextmanager
def plane_installed(**kw):
    """A fresh DevicePlane (`kw` its knobs) as the process-wide one while
    open, its dispatches recorded (`timed_plane_class`); the one before it
    afterwards, both drained."""
    from fisco_bcos_tpu_torch.device import plane as plane_mod

    drain_plane()
    saved = plane_mod._PLANE
    plane = timed_plane_class()(**kw)
    plane_mod._PLANE = plane
    try:
        yield plane
    finally:
        if not plane.drain(timeout=120):
            raise AssertionError("an installed DevicePlane did not drain within 120 s")
        plane_mod._PLANE = saved


@contextlib.contextmanager
def passthrough():
    """FISCO_DEVICE_PLANE=0 while open: every seam takes its direct path on
    the caller's thread."""
    old = os.environ.get("FISCO_DEVICE_PLANE")
    os.environ["FISCO_DEVICE_PLANE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["FISCO_DEVICE_PLANE"]
        else:
            os.environ["FISCO_DEVICE_PLANE"] = old


def concurrently(calls) -> tuple[list, list[float], float]:
    """Each zero-argument call on a thread of its own, all released
    together: (results, each call's ms, wall ms from the first start to the
    last end). A call's exception is raised here."""
    barrier = threading.Barrier(len(calls))
    out: list = [None] * len(calls)
    spans: list = [None] * len(calls)

    def worker(i):
        barrier.wait()
        t0 = time.perf_counter()
        try:
            out[i] = calls[i]()
        except BaseException as e:  # noqa: BLE001 - raised on the main thread below
            out[i] = e
        spans[i] = (t0, time.perf_counter())

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for o in out:
        if isinstance(o, BaseException):
            raise o
    wall = (max(e for _, e in spans) - min(s for s, _ in spans)) * 1e3
    return out, [(e - s) * 1e3 for s, e in spans], wall


def on_stream(fn):
    """`fn` run inside torch.cuda.stream of a stream of its own (not the
    default one): a caller whose downloads must follow the worker's
    launches by the event the resolvers wait on, not by the default
    stream."""
    import torch

    def run():
        with torch.cuda.stream(torch.cuda.Stream()):
            return fn()

    return run


def plane_seams(device, cases, verify_cases, sm_cases, ed_cases) -> list[tuple]:
    """(op, call(lo, hi), launches of one merged call) of every routed seam,
    a call on lanes [lo, hi) of the mixed blocks (hashes: the mixed hash
    block; keys: the recover block's, zero keys included)."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto import admission, suite

    msgs = hash_mixed_messages()
    _, rec_sigs, picked = tile(cases, BLOCK_TXS)
    payloads = [c[0] for c in picked]
    _, _, rec_pubs, rec_hashes = expected_admission(picked)
    hashes, rs, ss, pubs, _ = verify_arrays(verify_cases, BLOCK_TXS)
    sigs65 = np.concatenate([rs, ss, np.zeros((BLOCK_TXS, 1), np.uint8)], axis=1)
    sm_payloads, sigs128, sm_picked = sm2_tile(sm_cases, BLOCK_TXS)
    _, _, _, sm_hashes = expected_admission_sm(sm_picked)
    (ed_msgs, ed_pubs, ed_sigs), _ = ed25519_tile(ed_cases, BLOCK_TXS)
    secp, sm2_impl, ed = (cls(device) for cls in (suite.Secp256k1Crypto, suite.SM2Crypto, suite.Ed25519Crypto))
    seams = []
    for name, cls in (("keccak256", suite.Keccak256), ("sm3", suite.SM3), ("sha256", suite.Sha256),
                      ("poseidon", suite.Poseidon)):
        impl = cls(device)
        sender = {"keccak256": "keccak256_sender", "sm3": "sm3_sender", "sha256": "sha256_packed",
                  "poseidon": "poseidon_packed"}[name]
        seams += [
            (f"hash.{name}", lambda lo, hi, impl=impl: impl.hash_batch(msgs[lo:hi]), {f"{name}_packed": 1}),
            (f"address.{name}", lambda lo, hi, impl=impl: impl.address_batch(rec_pubs[lo:hi]), {sender: 1}),
        ]
    seams += [
        ("verify.secp256k1", lambda lo, hi: secp.batch_verify(hashes[lo:hi], pubs[lo:hi], sigs65[lo:hi]),
         {"secp256k1_verify": 1}),
        ("recover.secp256k1", lambda lo, hi: secp.batch_recover(rec_hashes[lo:hi], rec_sigs[lo:hi]),
         {"secp256k1_recover": 1}),
        ("verify.sm2", lambda lo, hi: sm2_impl.batch_verify(sm_hashes[lo:hi], sigs128[lo:hi, 64:], sigs128[lo:hi]),
         SM2_VERIFY_LAUNCHES),
        ("recover.sm2", lambda lo, hi: sm2_impl.batch_recover(sm_hashes[lo:hi], sigs128[lo:hi]),
         SM2_VERIFY_LAUNCHES),
        ("verify.ed25519", lambda lo, hi: ed.batch_verify(ed_msgs[lo:hi], ed_pubs[lo:hi], ed_sigs[lo:hi]),
         ED25519_VERIFY_LAUNCHES),
        ("admission", lambda lo, hi: admission.admit_batch(payloads[lo:hi], rec_sigs[lo:hi], device=device),
         ADMIT_LAUNCHES),
        ("admission_sm", lambda lo, hi: admission.admit_batch_sm(sm_payloads[lo:hi], sigs128[lo:hi], device=device),
         ADMIT_SM_LAUNCHES),
    ]
    return seams


def check_plane_seams(card: str, device, cases, verify_cases, sm_cases, ed_cases) -> None:
    """Every routed seam: callers of PLANE_RAGGED lanes, released together,
    merged into one dispatch (stats()) that makes one call's launches
    (counted_run), each caller's result equal byte for byte to its own
    direct call (FISCO_DEVICE_PLANE=0); the first caller runs on a stream
    of its own. Then each suite's merkle_tree over ragged leaf counts: one
    dispatch, a tree a request, equal to the direct trees."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto import suite

    bounds = np.cumsum((0,) + PLANE_RAGGED).tolist()
    spans = list(zip(bounds[:-1], bounds[1:]))
    seams = plane_seams(device, cases, verify_cases, sm_cases, ed_cases)
    for op, call, launches in seams:
        with passthrough():
            direct = [call(lo, hi) for lo, hi in spans]
        calls = [lambda lo=lo, hi=hi: call(lo, hi) for lo, hi in spans]
        calls[0] = on_stream(calls[0])
        with plane_installed(window_ms=60_000, high_water=bounds[-1], starvation_ms=60_000) as plane:
            (merged, _, _), _ = counted_run(lambda: concurrently(calls), launches, f"merged {op}")
            stats = plane.stats()
        if stats["dispatches"] != 1 or stats["merged_requests"] != len(spans):
            raise AssertionError(f"{op}: {len(spans)} callers were not merged into one dispatch: {stats}")
        for (lo, hi), got, want in zip(spans, merged, direct):
            if not same_outputs(got, want):
                raise AssertionError(f"{op}: the merged caller of lanes [{lo}, {hi}) != its direct call")
    log(f"[{card}] DevicePlane: every seam ({', '.join(op for op, _, _ in seams)}) "
        f"with callers of {' / '.join(map(str, PLANE_RAGGED))} lanes released together, the first on a stream "
        f"of its own: one dispatch, one call's launches, each caller == its direct call byte for byte")
    gen = np.random.default_rng(SEED + 9)
    sizes = [max(n, 2) for n in PLANE_RAGGED]  # one leaf takes the direct path, as in JAX
    forests = [gen.integers(0, 256, (n, 32), dtype=np.uint8) for n in sizes]
    for name, cls in (("keccak256", suite.Keccak256), ("sm3", suite.SM3), ("sha256", suite.Sha256),
                      ("poseidon", suite.Poseidon)):
        suite_ = suite.CryptoSuite(cls(device), suite.Secp256k1Crypto(device))
        with passthrough():
            direct = [suite_.merkle_tree(leaves) for leaves in forests]
        calls = [lambda leaves=leaves: suite_.merkle_tree(leaves) for leaves in forests]
        calls[0] = on_stream(calls[0])
        with plane_installed(window_ms=60_000, high_water=sum(sizes), starvation_ms=60_000) as plane:
            trees, _, _ = concurrently(calls)
            stats = plane.stats()
        if stats["dispatches"] != 1:
            raise AssertionError(f"merkle_tree.{name}: not one dispatch: {stats}")
        for got, want in zip(trees, direct):
            if got.root != want.root or not all(np.array_equal(a, b) for a, b in zip(got.levels, want.levels)):
                raise AssertionError(f"merkle_tree.{name}: a merged tree != its direct build")
    log(f"[{card}] DevicePlane: merkle_tree of each hasher over {' / '.join(map(str, sizes))} leaves released "
        f"together: one dispatch, every tree == its direct build")


def check_stream_order(card: str, device) -> None:
    """A hash caller inside torch.cuda.stream of a stream of its own, alone
    on a plane with a window (so the worker launches, on its own stream,
    and the caller's resolver is the only one): the worker's stream sleeps
    ~30 ms just before each launch, so the caller's download gives the
    right digests only if it waits on the event recorded after the launch.
    Messages no earlier call hashed, so stale bytes cannot match. The
    control: the same slowed launch and a copy on another stream with no
    wait, which reads the bytes from before the kernel."""
    import torch

    from fisco_bcos_tpu_torch.crypto import suite
    from fisco_bcos_tpu_torch.crypto.ref import keccak as ref_keccak
    from fisco_bcos_tpu_torch.crypto.ref import sha2 as ref_sha2
    from fisco_bcos_tpu_torch.crypto.ref import sm3 as ref_sm3
    from fisco_bcos_tpu_torch.ops import hash_common, keccak, sha256, sm3

    gen = random.Random(SEED + 11)
    shown = []
    for cls, module, launch, oracle in (
        (suite.Keccak256, keccak, "keccak256_packed", ref_keccak.keccak256),
        (suite.SM3, sm3, "sm3_packed", ref_sm3.sm3),
        (suite.Sha256, sha256, "sha256_packed", ref_sha2.sha256),
    ):
        msgs, control = ([gen.randbytes(gen.randrange(0, 300)) + b"stream order %d %d" % (k, i) for i in range(1000)]
                         for k in range(2))
        fast = getattr(module, launch)

        def slowed(*args, fast=fast):
            torch.cuda._sleep(STREAM_SLEEP_CYCLES)
            return fast(*args)

        setattr(module, launch, slowed)
        try:
            with plane_installed(window_ms=1.0) as plane:
                with torch.cuda.stream(torch.cuda.Stream()):
                    got = cls(device).hash_batch(msgs)
            threads = {r["thread"] for r in plane.releases}
            if [bytes(d) for d in got] != [oracle(m) for m in msgs] or threads != {"device-plane"}:
                raise AssertionError(f"stream order: {cls.name} on a stream of its own != the oracle "
                                     f"(dispatched on {threads})")
            digests = slowed(*hash_common.upload_packed(control, device))
            with torch.cuda.stream(torch.cuda.Stream()):
                early = digests.cpu().numpy()
            torch.cuda.synchronize()
            late = digests.cpu().numpy()
        finally:
            setattr(module, launch, fast)
        if [bytes(d) for d in late] != [oracle(m) for m in control]:
            raise AssertionError(f"stream order: the control's {cls.name} launch != the oracle")
        shown.append(f"{cls.name} == oracle on all {len(msgs):,} lanes; control "
                     f"{int((early != late).any(axis=1).sum()):,} of {len(control):,} digests stale")
    log(f"[{card}] stream order: a hash caller alone on a stream of its own, the worker's stream asleep "
        f"{STREAM_SLEEP_CYCLES:,} cycles before the launch: " + "; ".join(shown)
        + " (the control copies on another stream with no wait: stale digests show the check can fail)")


def plane_window_anatomy(card: str, calls: dict) -> None:
    """Where a lone 4-lane QC check's time goes at each window of
    PLANE_WINDOWS_MS (median of PLANE_ANATOMY_CALLS warm calls, each alone
    after a drain; at window 0 also back to back as host_ms times them,
    beside direct calls): the call to its enqueue, the enqueue to the
    dispatch's start (the window and the lag past it), the dispatch, and
    its end to the caller's return; what a timed wait of each window takes
    on this host, and what a yield of the interpreter (time.sleep(0),
    os.sched_yield) costs there."""
    import torch

    qc = lambda: calls["Ed25519 batch_verify"](0, 4)  # noqa: E731
    shown = []
    for window, back_to_back in [(0.0, True)] + [(w, False) for w in PLANE_WINDOWS_MS]:
        spans = []
        with plane_installed(window_ms=window) as plane:
            qc()
            torch.cuda.synchronize()
            plane.drain(timeout=10)
            seen = len(plane.releases)
            for _ in range(PLANE_ANATOMY_CALLS):
                if not back_to_back:
                    torch.cuda.synchronize()
                    plane.drain(timeout=10)
                t0 = time.perf_counter()
                qc()
                spans.append((t0, time.perf_counter()))
                if back_to_back:
                    torch.cuda.synchronize()
            plane.drain(timeout=10)
            rows = [((rel["t_enq"] - t0) * 1e3, (rel["start"] - rel["t_enq"]) * 1e3, rel["lag_ms"],
                     (rel["end"] - rel["start"]) * 1e3, (t1 - rel["end"]) * 1e3, (t1 - t0) * 1e3)
                    for (t0, t1), rel in zip(spans, plane.releases[seen:], strict=True)]
        med = [statistics.median(r[i] for r in rows) for i in range(6)]
        shown.append(f"window {window} ms{', back to back' if back_to_back else ''}: call {med[5]:.3f} = to enqueue "
                     f"{med[0]:.3f} + enqueue to dispatch {med[1]:.3f} (lag past the window {med[2]:.3f}) + "
                     f"dispatch {med[3]:.3f} + to return {med[4]:.3f}")
    with passthrough():
        direct = []
        for _ in range(PLANE_ANATOMY_CALLS):
            t0 = time.perf_counter()
            qc()
            direct.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    log(f"[{card}] lone QC check (4 lanes) by segment, median ms of {PLANE_ANATOMY_CALLS} (each call alone after "
        f"a drain, or back to back as host_ms times them): " + "; ".join(shown)
        + f"; direct, back to back, {statistics.median(direct):.3f}")
    waits = []
    for window in PLANE_WINDOWS_MS[1:]:
        took = []
        for _ in range(20):
            t0 = time.perf_counter()
            threading.Event().wait(window / 1e3)
            took.append((time.perf_counter() - t0) * 1e3)
        waits.append(f"{window} ms -> {statistics.median(took):.3f} (max {max(took):.3f})")
    for what, fn in (("time.sleep(0)", lambda: time.sleep(0)), ("os.sched_yield()", os.sched_yield)):
        took = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn()
            took.append((time.perf_counter() - t0) * 1e3)
        waits.append(f"{what} -> {statistics.median(took):.4f} (max {max(took):.3f})")
    log(f"[{card}] a timed threading wait on this host, asked -> took, median ms of 20 (of 200 for the "
        f"yields): " + "; ".join(waits))


def plane_calls(device, block, verify_block, sm_block, ed_block) -> dict:
    """The plane phase's calls on the timed blocks (every lane valid): each
    (lo, hi) -> the call on lanes [lo, hi)."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto import admission, suite

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    hashes, rs, ss, pubs, _ = verify_arrays(verify_block, BLOCK_TXS)
    v_sigs = np.concatenate([rs, ss, np.zeros((BLOCK_TXS, 1), np.uint8)], axis=1)
    _, sigs128, sm_picked = sm2_tile(sm_block, BLOCK_TXS)
    _, _, _, sm_hashes = expected_admission_sm(sm_picked)
    (ed_msgs, ed_pubs, ed_sigs), _ = ed25519_tile(ed_block, BLOCK_TXS)
    secp, sm2_impl, ed = (cls(device) for cls in (suite.Secp256k1Crypto, suite.SM2Crypto, suite.Ed25519Crypto))
    return {
        "secp256k1 batch_verify": lambda lo, hi: secp.batch_verify(hashes[lo:hi], pubs[lo:hi], v_sigs[lo:hi]),
        "sm2 batch_verify": lambda lo, hi: sm2_impl.batch_verify(sm_hashes[lo:hi], sigs128[lo:hi, 64:], sigs128[lo:hi]),
        "Ed25519 batch_verify": lambda lo, hi: ed.batch_verify(ed_msgs[lo:hi], ed_pubs[lo:hi], ed_sigs[lo:hi]),
        "admit_batch": lambda lo, hi: admission.admit_batch(payloads[lo:hi], sigs65[lo:hi], device=device),
    }


def all_ok(out) -> bool:
    ok = out[1] if isinstance(out, tuple) else out
    return bool(ok.all())


def plane_lone_calls(card: str, calls: dict) -> None:
    """A lone call, direct and through the plane, at each window of
    PLANE_WINDOWS_MS, in turns direct, plane, plane, direct (median ms of 5
    warm calls each, synchronised host clock)."""
    lone = {
        "QC check (Ed25519 batch_verify, 4 lanes)": lambda: calls["Ed25519 batch_verify"](0, 4),
        "QC check (Ed25519 batch_verify, 7 lanes)": lambda: calls["Ed25519 batch_verify"](0, 7),
        "secp256k1 batch_verify, 4 lanes": lambda: calls["secp256k1 batch_verify"](0, 4),
        f"admit_batch, {BLOCK_TXS:,} txs": lambda: calls["admit_batch"](0, BLOCK_TXS),
    }
    for what, fn in lone.items():
        if not all_ok(fn()):
            raise AssertionError(f"{what}: a valid lane of the timed block was not ok")

        def direct(fn=fn):
            with passthrough():
                return fn()

        shown = []
        for window in PLANE_WINDOWS_MS:
            with plane_installed(window_ms=window):
                turns = [host_ms(f, reps=5) for f in (direct, fn, fn, direct)]
            shown.append(f"window {window} ms: direct {turns[0]:.3f} / {turns[3]:.3f}, plane {turns[1]:.3f} / "
                         f"{turns[2]:.3f}")
        log(f"[{card}] lone {what}, ms in turns: " + "; ".join(shown))


def plane_concurrent_callers(card: str, calls: dict) -> None:
    """k = 4, 16, 64 concurrent callers of 4-lane batch_verify on each curve
    and of 64-tx admit_batch, each on its own lanes of the timed blocks:
    the wall time of all k, serial direct calls against merged through the
    plane, in turns serial, merged, merged, serial (median of 3 each), at
    each window of PLANE_CONCURRENT_WINDOWS_MS; each caller's p50 and p99
    and the plane's dispatches and coalesce ratio over the merged runs."""
    import torch

    for what, call in calls.items():
        n = 64 if what == "admit_batch" else 4
        for k in PLANE_CALLERS:
            fns = [lambda i=i: call(i * n, i * n + n) for i in range(k)]

            def serial():
                with passthrough():
                    t0 = time.perf_counter()
                    outs = [f() for f in fns]
                    torch.cuda.synchronize()
                    return outs, (time.perf_counter() - t0) * 1e3

            for window in PLANE_CONCURRENT_WINDOWS_MS:
                with plane_installed(window_ms=window) as plane:
                    concurrently(fns)  # warm: the worker thread is started
                    before = plane.stats()
                    runs = {"serial": [], "merged": []}
                    latencies = []
                    for kind in ("serial", "merged", "merged", "serial"):
                        for _ in range(3):
                            if kind == "serial":
                                outs, wall = serial()
                            else:
                                outs, lat, wall = concurrently(fns)
                                latencies += lat
                            if not all(all_ok(o) for o in outs):
                                raise AssertionError(f"{what}: a valid lane was not ok ({kind}, k = {k})")
                            runs[kind].append(wall)
                    after = plane.stats()
                dispatches = after["dispatches"] - before["dispatches"]
                requests = after["requests"] - before["requests"]
                p50, p99 = (statistics.quantiles(latencies, n=100, method="inclusive")[q] for q in (49, 98))
                s, m = (runs[kind] for kind in ("serial", "merged"))
                log(f"[{card}] {k} concurrent {what} callers of {n} lanes, window {window} ms: all k "
                    f"serial direct {statistics.median(s[:3]):.3f} / {statistics.median(s[3:]):.3f} ms, merged "
                    f"{statistics.median(m[:3]):.3f} / {statistics.median(m[3:]):.3f} ms (in turns); a caller "
                    f"p50 {p50:.3f}, p99 {p99:.3f} ms; {dispatches} dispatches for {requests} requests "
                    f"(coalesce ratio {requests / dispatches:.2f})")


def plane_lanes_under_load(card: str, calls: dict) -> None:
    """A 4-lane QC check queued behind a 10,240-tx admit_batch in flight and
    PLANE_SMALL_ADMISSIONS queued 4-tx admissions. The big dispatch is held
    at its start until the small ones and the QC check are queued, so the
    queue is the same in every run. With starvation off (a rule of 60 s)
    the lanes alone order the next dispatches: the QC check in the
    consensus lane, then in the admission lane. Then the QC check in the
    consensus lane with a starvation rule of STARVED_MS and the small
    admissions aged STARVED_AGE_MS more before it is queued: the starved
    queue overtakes the lane. Each run: the dispatches after the big one in
    order, each queue's oldest age at release, the QC check's latency from
    its call, the big call's, and the small ones' p50 and p99."""
    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.device.plane import device_lane

    qc = lambda: calls["Ed25519 batch_verify"](0, 4)  # noqa: E731
    with passthrough():
        idle = host_ms(qc, reps=5)
    direct_body = admission._admit_direct
    hold = threading.Event()

    def held(payloads, sigs, dev, **kw):
        if len(payloads) == BLOCK_TXS:
            hold.wait()
        return direct_body(payloads, sigs, dev, **kw)

    def wait_for(cond, what):
        deadline = time.perf_counter() + 30
        while not cond():
            if time.perf_counter() > deadline:
                raise AssertionError(f"lanes under load: {what} did not happen within 30 s")
            time.sleep(0.0001)

    shown = []
    admission._admit_direct = held
    try:
        for lane, starvation_ms, aged_ms in (("consensus", 60_000.0, 0.0), ("admission", 60_000.0, 0.0),
                                             ("consensus", STARVED_MS, STARVED_AGE_MS)):
            with plane_installed(window_ms=0, starvation_ms=starvation_ms) as plane:
                hold.set()
                qc(), calls["admit_batch"](0, BLOCK_TXS)  # warm
                hold.clear()
                spans: dict = {}

                def timed(key, fn, lane_of_call=None):
                    def run():
                        with contextlib.ExitStack() as stack:
                            if lane_of_call:
                                stack.enter_context(device_lane(lane_of_call))
                            t0 = time.perf_counter()
                            fn()
                            spans[key] = (time.perf_counter() - t0) * 1e3

                    t = threading.Thread(target=run)
                    t.start()
                    return t

                seen = len(plane.releases)
                threads = [timed("big", lambda: calls["admit_batch"](0, BLOCK_TXS))]
                wait_for(lambda: plane._busy and not plane.stats()["queue_depth"], "the big dispatch")
                threads += [timed(i, lambda i=i: calls["admit_batch"](4 * i, 4 * i + 4))
                            for i in range(PLANE_SMALL_ADMISSIONS)]
                depth = 4 * PLANE_SMALL_ADMISSIONS
                wait_for(lambda: plane.stats()["queue_depth"] == depth, "queueing the small admissions")
                time.sleep(aged_ms / 1e3)
                threads.append(timed("qc", qc, lane))
                wait_for(lambda: plane.stats()["queue_depth"] == depth + 4, "queueing the QC check")
                hold.set()
                for t in threads:
                    t.join()
            after = plane.releases[seen + 1:]
            order = [f"{r['op'].split('.')[0]} ({len(r['ages_ms'])} requests, lanes "
                     f"{'/'.join(sorted({lane_ for lane_, _ in r['ages_ms']}))}, oldest "
                     f"{max(a for _, a in r['ages_ms']):.3f} ms at release)" for r in after]
            qc_first = not after[0]["op"].startswith("admission")
            small = [v for k, v in spans.items() if isinstance(k, int)]
            p50, p99 = (statistics.quantiles(small, n=100, method="inclusive")[q] for q in (49, 98))
            shown.append(f"QC in the {lane} lane, starvation rule {starvation_ms:g} ms, small admissions aged "
                         f"{aged_ms:g} ms more: {'QC' if qc_first else 'small admissions'} first; after the big "
                         f"dispatch {', then '.join(order)}; QC {spans['qc']:.3f} ms (big {spans['big']:.3f} ms; small "
                         f"admissions p50 {p50:.3f}, p99 {p99:.3f} ms)")
    finally:
        admission._admit_direct = direct_body
        hold.set()
    log(f"[{card}] lanes under load ({BLOCK_TXS:,}-tx admit_batch in flight, held at its start until "
        f"{PLANE_SMALL_ADMISSIONS} 4-tx admissions and the QC check were queued): " + "; ".join(shown)
        + f"; the QC check alone, direct, {idle:.3f} ms")


def run_plane_phase(card: str, device, cases, verify_cases, sm_cases, ed_cases,
                    block, verify_block, sm_block, ed_block) -> None:
    """The DevicePlane on the card (ROADMAP A4): every seam merged and
    equal to its direct call; a download ordered by its event; a lone call
    at each window, and where its time goes; concurrent callers merged
    against serial direct calls; the lanes under load, and starvation."""
    t0 = time.perf_counter()
    check_plane_seams(card, device, cases, verify_cases, sm_cases, ed_cases)
    check_stream_order(card, device)
    calls = plane_calls(device, block, verify_block, sm_block, ed_block)
    plane_lone_calls(card, calls)
    plane_window_anatomy(card, calls)
    plane_concurrent_callers(card, calls)
    plane_lanes_under_load(card, calls)
    log(f"plane phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# The multi-device fan-out (parallel/sharding.py)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4)  # mesh entries: one card, then logical meshes naming it 2 and 4 times
SHARD_REPS = 9  # timed calls a variant, in turns
MERKLE_SHARD_LEAVES = 16**3  # leaves a shard: each shard's fold is a node of the one-device tree


def verify_host_rows(rows, n: int):
    """(hash, r, s, (qx, qy)) rows tiled to n lanes as the verify kernel's
    [n, 160] uint8 rows, on the host."""
    import numpy as np

    b = lambda v: v.to_bytes(32, "big")  # noqa: E731
    joined = b"".join(h + b(r) + b(s) + b(q[0]) + b(q[1]) for h, r, s, q in rows)
    return np.tile(np.frombuffer(joined, dtype=np.uint8).reshape(len(rows), 160), (-(-n // len(rows)), 1))[:n]


def sharded_programs(device, cases, verify_cases, sm_cases, ed_cases) -> list[tuple]:
    """The eight programs on the mixed 10,240-lane blocks: (name, maker,
    host arguments, the one-device call's outputs on the card as numpy
    arrays, a checker of one output against them, a shard's launches)."""
    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.ops import ed25519, secp256k1, sm2
    from fisco_bcos_tpu_torch.parallel import sharding

    def up(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]

    def oks(want_ok, weights=None):
        def check(out):
            ok, count = (t.cpu().numpy() for t in out)
            total = weights[want_ok].sum() if weights is not None else want_ok.sum()
            return np.array_equal(ok, want_ok) and int(count) == int(total)
        return check

    payloads, sigs65, _ = tile(cases, BLOCK_TXS)
    adm = admission.host_inputs(payloads, sigs65)
    packed = admission._admission_packed(*up(adm)).cpu().numpy()
    rows = verify_host_rows(verify_cases, BLOCK_TXS)
    verify_ok = secp256k1.verify_device(*up([rows])).cpu().numpy()
    weights = np.random.default_rng(SEED + 21).integers(1, 1000, size=BLOCK_TXS, dtype=np.int32)
    sm_payloads, sigs128, _ = sm2_tile(sm_cases, BLOCK_TXS)
    sm_in = sm2_device_inputs(sm_payloads, sigs128, device)
    sm_ok = sm2.verify_device(*sm_in).cpu().numpy()
    (msgs, pubs, sigs), _ = ed25519_tile(ed_cases, BLOCK_TXS)
    ed_rows = ed25519.device_inputs(msgs, pubs, sigs, pad_to=BLOCK_TXS)
    ed_ok = ed25519.verify_device(*up([ed_rows])).cpu().numpy()
    digests = np.random.default_rng(SEED + 22).integers(0, 2**32, size=(BLOCK_TXS, 8), dtype=np.uint32)

    def admission_check(out):
        addr, ok, count = (t.cpu().numpy() for t in out)
        return (np.array_equal(addr, packed[:, :20]) and np.array_equal(ok, packed[:, 20] != 0)
                and int(count) == int(ok.sum()))

    return [
        ("sharded_admission_packed", sharding.sharded_admission_packed, adm,
         lambda out: np.array_equal(out.cpu().numpy(), packed), ADMIT_LAUNCHES),
        ("sharded_admission", sharding.sharded_admission, adm, admission_check, ADMIT_LAUNCHES),
        ("sharded_verify", sharding.sharded_verify, (rows,), oks(verify_ok), {"secp256k1_verify": 1}),
        ("sharded_qc_check", sharding.sharded_qc_check, (rows, weights), oks(verify_ok, weights),
         {"secp256k1_verify": 1}),
        ("sharded_sm2_verify", sharding.sharded_sm2_verify, [t.cpu().numpy() for t in sm_in], oks(sm_ok),
         {"sm2_verify": 1}),
        ("sharded_ed25519_verify", sharding.sharded_ed25519_verify, (ed_rows,), oks(ed_ok), {"ed25519_verify": 1}),
        ("sharded_state_root", sharding.sharded_state_root, (digests,),
         lambda out: np.array_equal(out.cpu().numpy().view(np.uint32), np.bitwise_xor.reduce(digests, axis=0)), {}),
    ]


def check_sharded_programs(card: str, device, programs, meshes: dict) -> None:
    """Each program at every mesh size, counted (a shard's launches times
    the shards, no plain version), its outputs on the mesh's first device
    and equal to the one-device call's; merkle at D·16^3 leaves against
    the one-device tree's padded root."""
    import numpy as np

    from fisco_bcos_tpu_torch.ops import merkle
    from fisco_bcos_tpu_torch.parallel import sharding

    shown = []
    for d, mesh in meshes.items():
        for name, maker, host, check, per_shard in programs:
            out, _ = counted_run(lambda: maker(mesh)(*host), {k: v * d for k, v in per_shard.items()},
                                 f"{name} at D = {d}")
            first = out if not isinstance(out, tuple) else out[0]
            if first.device != mesh.devices[0] or not check(out):
                raise AssertionError(f"{name} at D = {d} != the one-device call on the mixed block")
        leaves = np.random.default_rng(SEED + 23 + d).integers(0, 256, size=(d * MERKLE_SHARD_LEAVES, 32),
                                                                dtype=np.uint8)
        want = merkle.MerkleTree(leaves, device=device).padded_root
        root, _ = counted_run(lambda: sharding.sharded_merkle_root(mesh)(leaves),
                              {"keccak256_packed": 3 * d + (d > 1)}, f"sharded_merkle_root at D = {d}")
        if bytes(root.cpu().numpy()) != want:
            raise AssertionError(f"sharded_merkle_root at D = {d} != the one-device padded root")
        shown.append(f"D = {d}: {len(programs) + 1} programs equal")
    log(f"[{card}] sharded programs on the mixed {BLOCK_TXS:,}-lane blocks against the one-device calls "
        f"(counted: a shard's launches times D, no plain version; merkle at D·{MERKLE_SHARD_LEAVES} leaves): "
        + "; ".join(shown))


def check_plane_on_one_card(card: str, cases) -> None:
    """admit_batch of the mixed block through the plane with no fan-out
    threshold: one card, so the one-device body under ``admission``, its
    bytes the host oracle's."""
    from fisco_bcos_tpu_torch.crypto import admission

    payloads, sigs65, picked = tile(cases, BLOCK_TXS)
    ops: list[str] = []
    span = admission.device_span
    saved = os.environ.get("FISCO_DEVICE_SHARD_MIN")
    admission.device_span = lambda op, *a, **kw: (ops.append(op), span(op, *a, **kw))[1]
    os.environ["FISCO_DEVICE_SHARD_MIN"] = "0"
    try:
        out = admission.admit_batch(payloads, sigs65)
    finally:
        admission.device_span = span
        if saved is None:
            os.environ.pop("FISCO_DEVICE_SHARD_MIN")
        else:
            os.environ["FISCO_DEVICE_SHARD_MIN"] = saved
    if ops != ["admission"]:
        raise AssertionError(f"admit_batch through the plane on one card gave the spans {ops}, not ['admission']")
    check_outputs(out, expected_admission(picked), "mixed block, through the plane with FISCO_DEVICE_SHARD_MIN=0")
    log(f"[{card}] admit_batch through the plane, FISCO_DEVICE_SHARD_MIN=0, one card: span 'admission' "
        f"(no fan-out), == host oracle")


def fan_out_uploads_first(mesh, shards, body) -> list[tuple]:
    """``parallel/sharding.py _fan_out`` in the order it did not take, for
    timing it: every shard's upload, then every body back to back (their
    kernels start closer together, but the card idles while the host
    uploads)."""
    import torch

    from fisco_bcos_tpu_torch.parallel.sharding import _shard_stream, _upload

    uploaded = []
    for i, (dev, arrays) in enumerate(zip(mesh.devices, shards)):
        with torch.cuda.device(dev):
            stream = _shard_stream(dev, i)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                uploaded.append((dev, stream, _upload(arrays, dev)))
    launched = []
    for dev, stream, tensors in uploaded:
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            outs = tuple(body(*tensors))
            done = torch.cuda.Event()
            done.record(stream)
        launched.append((dev, done, outs))
    gathered = []
    for dev, done, outs in launched:
        reader = torch.cuda.current_stream(dev)
        reader.wait_event(done)
        for t in outs:
            t.record_stream(reader)
        gathered.append(tuple(t.to(mesh.devices[0]) for t in outs))
    return gathered


def time_fan_out(card: str, device, block, meshes: dict) -> None:
    """sharded_admission_packed at each mesh size in turns with the
    one-device body, each from the same host arrays (uploads included), the
    median of SHARD_REPS, with the segments the caching allocator took from
    cudaMalloc; at each size above one also in the order not taken
    (fan_out_uploads_first) and with a fresh pool stream a shard a call in
    place of _shard_stream's; one profiled call at the largest size in
    both orders and at one: the kernels' summed device time over their
    union shows whether the shards' kernels overlap, and the recover
    kernels' start times how far apart the host launched them."""
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.parallel import sharding

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    host = admission.host_inputs(payloads, sigs65)
    kept_order, kept_streams = sharding._fan_out, sharding._shard_stream

    def fresh_streams(dev, shard):  # a pool stream a call: its allocator cache is another stream's
        return torch.cuda.Stream(dev)

    def variant(step, fan=kept_order, streams=kept_streams):
        def run():
            sharding._fan_out, sharding._shard_stream = fan, streams
            try:
                return step(*host)
            finally:
                sharding._fan_out, sharding._shard_stream = kept_order, kept_streams
        return run

    variants = {"one-device _admission_packed":
                lambda: admission._admission_packed(*(torch.from_numpy(a).to(device) for a in host))}
    for d, mesh in meshes.items():
        step = sharding.sharded_admission_packed(mesh)
        variants[f"D = {d}"] = variant(step)
        if d > 1:
            variants[f"D = {d} uploads first"] = variant(step, fan=fan_out_uploads_first)
            variants[f"D = {d} fresh streams"] = variant(step, streams=fresh_streams)
    times: dict[str, list[float]] = {k: [] for k in variants}
    segments = dict.fromkeys(variants, 0)  # the caching allocator's cudaMalloc calls in the timed calls
    for fn in variants.values():
        fn()
    for rep in range(SHARD_REPS):
        for name in (list(variants) if rep % 2 == 0 else list(reversed(variants))):
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats(device).get("segment.all.allocated", 0)
            t0 = time.perf_counter()
            variants[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            segments[name] += torch.cuda.memory_stats(device).get("segment.all.allocated", 0) - before
    log(f"[{card}] sharded_admission_packed @ {BLOCK_TXS:,} txs, from the host arrays (uploads included), "
        f"median of {SHARD_REPS} in turns, ms (segments the allocator took from cudaMalloc in those calls): "
        + ", ".join(f"{k} {statistics.median(v):.4f} ({min(v):.4f}-{max(v):.4f}; {segments[k]})"
                    for k, v in times.items())
        + "; the fan-out's own cost on one card (logical shards share its SMs): not a multi-card speed")
    top = max(meshes)
    for name in (f"D = {top}", f"D = {top} uploads first", "D = 1"):
        events, wall = profiled_events(variants[name])
        kernels = [e for e in events if not is_copy(e)]
        if not kernels:
            log(f"[{card}] sharded_admission_packed at {name}, one profiled call: not measured "
                "(no device events in the trace)")
            continue
        summed = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
        union = union_us(kernels) / 1e3
        rec = sorted((e.time_range.start, e.time_range.end) for e in kernels if "recover" in e.name)
        starts = ", ".join(f"{(lo - rec[0][0]) / 1e3:.4f}" for lo, _ in rec)
        lasts = ", ".join(f"{(hi - lo) / 1e3:.4f}" for lo, hi in rec)
        log(f"[{card}] sharded_admission_packed at {name}, one profiled call: {len(kernels)} kernels, their "
            f"device times sum to {summed:.4f} ms over a union of {union:.4f} ms (x{summed / union:.3f}: above 1 "
            f"the shards' kernels overlap); the recover kernels start at +[{starts}] ms and last [{lasts}] ms; "
            f"device busy {union_us(events) / 1e3:.4f} ms of {wall:.3f} ms wall, {len(events) - len(kernels)} copies")


def run_sharding_phase(card: str, device, cases, verify_cases, sm_cases, ed_cases, block) -> None:
    """The multi-device fan-out (ROADMAP A9) on one card: the real mesh;
    every program equal to its one-device call at one entry and on logical
    meshes of 2 and 4 (a stream a shard); the plane's admission without a
    fan-out on one card; the fan-out's times; the calling thread's current
    device unchanged by the phase."""
    import torch

    from fisco_bcos_tpu_torch.parallel import sharding

    t0 = time.perf_counter()
    before = torch.cuda.current_device()
    real = sharding.make_mesh()
    cards = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    if real.devices != cards:
        raise AssertionError(f"make_mesh() gave {real.devices}, not the cards {cards}")
    try:
        sharding.make_mesh(len(cards) + 1)
    except ValueError:
        pass
    else:
        raise AssertionError("make_mesh asked for more cards than there are did not raise")
    meshes = {d: sharding.make_mesh(1) if d == 1 else sharding.Mesh((device,) * d) for d in SHARD_COUNTS}
    programs = sharded_programs(device, cases, verify_cases, sm_cases, ed_cases)
    check_sharded_programs(card, device, programs, meshes)
    check_plane_on_one_card(card, cases)
    time_fan_out(card, device, block, meshes)
    after = torch.cuda.current_device()
    if after != before:
        raise AssertionError(f"the current device moved from {before} to {after} during the sharding phase")
    log(f"[{card}] sharding phase: the real mesh {[str(d) for d in real.devices]} ({len(cards)} card(s)); "
        f"make_mesh({len(cards) + 1}) raised ValueError; current device {before} before and after; "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Against another checkout's kernels
# ---------------------------------------------------------------------------


def load_kernels_module(checkout: str):
    """The ``fisco_bcos_tpu_torch/ops/_kernels.py`` of another checkout,
    loaded under its own module name: it builds that checkout's sources
    into that checkout and keeps its own launch counts."""
    path = Path(checkout).resolve() / "fisco_bcos_tpu_torch" / "ops" / "_kernels.py"
    spec = importlib.util.spec_from_file_location("other_checkout_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed_kernel_args(device, block, verify_block, sm_block, forms: dict, ed_block, poseidon_blocks) -> dict:
    """Each kernel's wrapper arguments on its timed block, comb included;
    the hash kernels' packed forms' on the tx payloads, their other forms'
    `forms` (form_inputs); SHA-256's on its mixed block and, keyed
    "sha256_packed@merkle level", its merkle level (sha256_timed_blocks);
    Poseidon's on its mixed block and, keyed "poseidon_packed@merkle
    level", its merkle level (run_poseidon_phase's timed blocks), each with
    the constants table."""
    from fisco_bcos_tpu_torch.ops import ed25519, poseidon, secp256k1, sm2
    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    *arrays, _ = verify_arrays(verify_block, BLOCK_TXS)
    sm_payloads, sigs128, _ = sm2_tile(sm_block, BLOCK_TXS)
    return {
        "secp256k1_recover": (*recover_inputs(payloads, sigs65, device), secp256k1.comb_words(device)),
        "secp256k1_verify": (verify_row_tensor(*arrays, device), secp256k1.verify_comb_words(device)),
        "sm2_verify": (*sm2_device_inputs(sm_payloads, sigs128, device), sm2.comb_words(device)),
        "keccak256_packed": upload_packed(payloads, device),
        "sm3_packed": upload_packed(sm_payloads, device),
        **{"sha256_packed" + ("" if what == "mixed" else f"@{what}"): args
           for what, (args, _) in sha256_timed_blocks(device).items()},
        **forms,
        "ed25519_verify": (ed25519_rows_tensor(*ed25519_tile(ed_block, BLOCK_TXS)[0], device),
                           ed25519.comb_words(device)),
        "ed25519_challenge": ed25519_challenge_args(*ed25519_tile(ed_block, BLOCK_TXS)[0], device),
        "poseidon_packed": (*poseidon_blocks["mixed"][0], poseidon.kernel_table(device)),
        "poseidon_packed@merkle level": (*poseidon_blocks["merkle level"][0], poseidon.kernel_table(device)),
    }


def takes_limbs(kernels) -> bool:
    """Whether a checkout's verify kernel predates the byte rows: its
    wrapper takes z, r, s, qx, qy and comb."""
    import inspect

    return len(inspect.signature(kernels.secp256k1_verify).parameters) == 6


def load_checkout_module(checkout: str, module: str):
    """A module of another checkout's port package (``ops.poseidon``, say),
    imported under an alias package, so that its relative imports resolve
    inside that checkout."""
    alias = "checkout_" + hashlib.sha256(str(Path(checkout).resolve()).encode()).hexdigest()[:12]
    if alias not in sys.modules:
        root = Path(checkout).resolve() / "fisco_bcos_tpu_torch"
        spec = importlib.util.spec_from_file_location(alias, root / "__init__.py",
                                                      submodule_search_locations=[str(root)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[alias] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.{module}")


def checkout_poseidon_table(checkout: str, device):
    """Another checkout's Poseidon constants table (its ops/poseidon.py
    KERNEL_TABLE, in its own kernel's layout) on `device`, or None where it
    has no Poseidon."""
    import torch

    from fisco_bcos_tpu_torch.ops import poseidon

    if Path(checkout).resolve() == Path(__file__).resolve().parent:
        return poseidon.kernel_table(device)
    if not (Path(checkout) / "fisco_bcos_tpu_torch" / "ops" / "poseidon.py").exists():
        return None
    return torch.from_numpy(load_checkout_module(checkout, "ops.poseidon").KERNEL_TABLE).to(device)


def parent_kernel_args(parent, device, verify_block, checkout: str, timed_args: dict) -> dict:
    """Arguments of the parent checkout's kernels whose input layout differs
    from this checkout's: a verify kernel from before the byte rows gets
    five [n, 16] limb tensors and the [60, 8] comb of 4-bit windows on the
    same timed block; the Poseidon kernel the same messages with the
    parent's own constants table."""
    from fisco_bcos_tpu_torch.ops import secp256k1

    out = {}
    table = checkout_poseidon_table(checkout, device)
    if table is not None:
        out.update({k: (*args[:3], table) for k, args in timed_args.items() if k.startswith("poseidon_packed")})
    if takes_limbs(parent):
        *arrays, _ = verify_arrays(verify_block, BLOCK_TXS)
        out["secp256k1_verify"] = (*verify_limbs(*arrays, device), secp256k1.comb_words(device))
    return out


# lanes at which a kernel is timed against the parent checkout's (others:
# the whole timed block)
PARENT_LANES = {"sha256_packed": (32, 132 * 32, BLOCK_TXS), "ed25519_challenge": CHALLENGE_LANES}
IN_PLACE = ("ed25519_challenge",)  # kernels that write their first argument


def first_lanes(args, n: int) -> tuple:
    """A kernel's timed arguments cut to their first n lanes (every
    argument with a row a lane of the timed block)."""
    return tuple(a[:n] if a.shape[0] == BLOCK_TXS else a for a in args)


def time_against_parent(card: str, parent, timed_args: dict, parent_args: dict) -> None:
    """Each kernel and the parent checkout's on the same timed block (each
    fed its own input layout, from `parent_args` where the layouts differ):
    equal on every lane, then CUDA-event times in turns parent, new, new,
    parent; at PARENT_LANES' lane counts where it names the kernel, else
    on the whole block. A kernel that writes its rows in place is compared
    on fresh copies."""
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels

    for name, args in timed_args.items():
        kernel = name.split("@")[0]
        old = getattr(parent, kernel, None)
        if old is None:
            log(f"[{card}] {name}: the parent checkout has no such kernel; not timed against it")
            continue
        new = getattr(_kernels, kernel)
        for n in PARENT_LANES.get(kernel, (BLOCK_TXS,)):
            part, old_part = first_lanes(args, n), first_lanes(parent_args.get(name, args), n)
            if kernel in IN_PLACE:
                got = new(part[0].clone(), *part[1:])
                want = old(old_part[0].clone(), *old_part[1:])
            else:
                got, want = new(*part), old(*old_part)
            pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(f"{name} kernel != the parent checkout's on the timed block at {n} lanes")
            turns = ((old, old_part), (new, part), (new, part), (old, old_part))
            times = [cuda_ms(lambda f=f, a=a: f(*a)) for f, a in turns]
            alone = ""
            if kernel in PARENT_LANES:  # the kernels alone too (profiler), in turns
                dev = [kernel_device_ms(lambda f=f, a=a: f(*a)) for f, a in turns]
                alone = "; alone " + ", ".join(f"{w} {show_device_ms(d)}" for w, d in
                                               zip(("parent", "new", "new", "parent"), dev))
                if all(dev):
                    alone += f" (new/parent {(dev[1][0] + dev[2][0]) / (dev[0][0] + dev[3][0]):.3f})"
            log(f"[{card}] {name} @ {n:,} lanes against the parent checkout (equal on every lane): "
                f"parent {times[0]:.4f}, new {times[1]:.4f}, new {times[2]:.4f}, parent {times[3]:.4f} ms "
                f"(new/parent {(times[1] + times[2]) / (times[0] + times[3]):.3f}){alone}")


FIELD_BENCH_OPS = 31  # field_bench.cu's op codes 0..30
# loop iterations of an op code (each median of 32 lanes' clock64()):
# cheap field ops many times, a group law or a Poseidon round fewer, a
# decompression or a Poseidon permutation twice
FIELD_BENCH_ITERS = {**dict.fromkeys((0, 1, 2, 3, 4, 5, 6, 15, 16, 21, 22, 29, 30), 400),
                     **dict.fromkeys((13, 14), 8), **dict.fromkeys((20, 28), 2),
                     **dict.fromkeys((23, 24, 25), 100)}
BODY_SIZES = (1, 4, 8, 16, 24, 32, 64)  # products a loop body, op code 100 + K


def sass_by_function(lib: Path) -> dict[str, int]:
    """SASS instructions of each function in a built library (``cuobjdump
    -sass``, beside nvcc); empty when the tool is missing."""
    from fisco_bcos_tpu_torch.ops import _kernels

    tool = Path(_kernels._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] = counts.get(name, 0) + 1
    return counts


STAGE_SIZES = (4096, 8192, 32768)  # staging buffers other than csrc/hash_kernel.cuh's 16 KiB


def build_stage_variant(stage_bytes: int) -> Path:
    """nvcc of csrc/keccak256.cu with a staging buffer of `stage_bytes`
    (-DHASH_STAGE_BYTES) into the build directory; returns the library."""
    from fisco_bcos_tpu_torch.ops import _kernels

    out = _kernels.BUILD_DIR / f"libkeccak256-stage{stage_bytes}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, f"-DHASH_STAGE_BYTES={stage_bytes}", "-o", str(out),
         str(_kernels.SOURCES["keccak256"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for keccak256 with a {stage_bytes}-byte stage:\n{proc.stdout}")
    return out


def stage_sweep(card: str, libs: dict, device) -> None:
    """The keccak packed form with each staging buffer size ({bytes:
    library}, the default build's 16 KiB included) on the 10,240 tx
    payloads, a merkle level over 10,240 leaves (640 groups of 512 bytes)
    and the mixed hash block: equal digests, the warps that staged, and the
    CUDA-event time a call, sizes in turns."""
    import ctypes

    import torch

    from fisco_bcos_tpu_torch.ops import _kernels
    from fisco_bcos_tpu_torch.ops.hash_common import upload_packed

    payloads = [b"bench parallel-transfer tx %06d" % (i % BENCH_SIGNERS) + b"\xab" * 64 for i in range(BLOCK_TXS)]
    leaves = torch.randint(0, 256, (BLOCK_TXS * 32,), dtype=torch.uint8, generator=torch.Generator().manual_seed(SEED))
    first = torch.arange(0, BLOCK_TXS, 16)
    level = (leaves.to(device), (first * 32).to(device), torch.full(first.shape, 512, dtype=torch.int32).to(device))
    blocks = {"tx payloads": upload_packed(payloads, device), "merkle level": level,
              "mixed hash block": upload_packed(hash_mixed_messages(), device)}
    fns = {}
    for size, path in libs.items():
        fn = ctypes.CDLL(str(path)).keccak256_launch
        fn.argtypes = _kernels._ENTRIES["keccak256_packed"][2] + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[size] = fn
    for what, (data, starts, lengths) in blocks.items():
        b = starts.shape[0]
        want = _kernels.keccak256_packed(data, starts, lengths)
        out = torch.empty_like(want)
        routes = torch.zeros(2, dtype=torch.int32, device=device)

        def call(fn, count=False):
            err = fn(data.data_ptr(), starts.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                     routes.data_ptr() if count else None, b, data.numel(), device.index,
                     torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"keccak256 stage variant launch failed: CUDA error {err}")

        shown = []
        for size in sorted(fns):
            routes.zero_()
            call(fns[size], count=True)
            if not torch.equal(out, want):
                raise AssertionError(f"keccak256 with a {size}-byte stage != the default build on the {what}")
            staged = routes.tolist()[0]
            times = [cuda_ms(lambda f=f: call(f)) for f in (fns[size], fns[size])]
            shown.append(f"{size // 1024} KiB {statistics.mean(times):.4f} ms ({staged} of {routes.sum().item()} "
                         f"warps staged)")
        log(f"[{card}] keccak256 packed, staging buffer sweep on the {what} (equal digests): " + "; ".join(shown))


def host_us(parts: dict) -> dict[str, float]:
    """Host µs a call of each part, the best of 5 runs of 1,000 calls, the
    card synchronised around each run."""
    import torch

    out = {}
    for what, part in parts.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                part()
            runs.append((time.perf_counter() - t0) * 1e3)  # ms for 1,000 calls: µs a call
        torch.cuda.synchronize()
        out[what] = min(runs)
    return out


def call_anatomy(card: str, args, ch_args, parent=None) -> None:
    """Where the host time of one call goes: a packed keccak call on the tx
    payloads (`args`), and a challenge call on the first 4 lanes (a QC
    check) of the Ed25519 timed block (`ch_args`): the wrapper's checks, an
    output allocation, the current stream read as an object and as the raw
    handle, the device guard of _kernels._launch (keccak), the bound C entry
    point alone, the whole wrapper (and, for the
    challenge, ed25519.challenge_device), and one small torch op beside
    them; with `parent`, the parent checkout's whole wrappers beside. Host
    clock a call, the best of 5 runs of 1,000 calls."""
    import torch

    from fisco_bcos_tpu_torch.ops import _kernels, ed25519

    data, starts, lengths = args
    dev, b = data.device, starts.shape[0]
    out = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    fn, _ = _kernels._entry("keccak256_packed")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def guard():  # what _kernels._launch adds around the C entry point
        with torch.cuda.device(dev):
            pass

    parts = {
        "checks": lambda: _kernels._packed_args("keccak256_packed", data, starts, lengths, None),
        "torch.empty": lambda: torch.empty((b, 32), dtype=torch.uint8, device=dev),
        "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "the raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "the device guard (an empty torch.cuda.device block)": guard,
        "the C entry point": lambda: fn(data.data_ptr(), starts.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                                        None, b, data.numel(), dev.index, stream),
        "the whole wrapper": lambda: _kernels.keccak256_packed(data, starts, lengths),
        "one small torch op (starts + 1)": lambda: starts + 1,
    }
    if parent is not None:
        parts["the parent checkout's whole wrapper"] = lambda: parent.keccak256_packed(data, starts, lengths)
    log(f"[{card}] keccak256_packed call anatomy, host µs a call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host_us(parts).items()))
    rows, data, starts, lengths = first_lanes(ch_args, 4)
    ch, _ = _kernels._entry("ed25519_challenge")
    b = starts.shape[0]
    full = ch_args
    parts = {
        "checks": lambda: _kernels._challenge_args(rows, data, starts, lengths),
        "three slices to 4 lanes (what the harness once timed with each call)":
            lambda: (full[0][:4], full[2][:4], full[3][:4]),
        "the C entry point": lambda: ch(rows.data_ptr(), data.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
                                        b, data.numel(), dev.index, stream),
        "the whole wrapper": lambda: _kernels.ed25519_challenge(rows, data, starts, lengths),
        "ed25519.challenge_device": lambda: ed25519.challenge_device(rows, data, starts, lengths),
        "one small torch op (starts + 1)": lambda: starts + 1,
    }
    if parent is not None and getattr(parent, "ed25519_challenge", None) is not None:
        parts["the parent checkout's whole wrapper"] = lambda: parent.ed25519_challenge(rows, data, starts, lengths)
    log(f"[{card}] ed25519_challenge call anatomy at 4 lanes, host µs a call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host_us(parts).items()))


def lane_scaling(card: str, timed_args: dict) -> None:
    """Each kernel on the first 32, 4,224 and 10,240 lanes of its timed
    block (one warp, one warp a SM, the block): CUDA-event time a call, and
    the device time of its kernel alone (profiler)."""
    from fisco_bcos_tpu_torch.ops import _kernels

    for name, args in timed_args.items():
        fn = getattr(_kernels, name.split("@")[0])
        times, device = [], []
        for n in (32, 132 * 32, BLOCK_TXS):
            part = first_lanes(args, n)
            times.append(cuda_ms(lambda: fn(*part)))
            device.append(kernel_device_ms(lambda: fn(*part)))
        log(f"[{card}] {name} at 32 / 4,224 / {BLOCK_TXS:,} lanes: "
            + " / ".join(f"{t:.4f}" for t in times) + " ms a call; the kernel alone (profiler) "
            + " / ".join(map(show_device_ms, device)))


# The field bench's hash ops (csrc/field_bench.cu op codes 31-44): (op code,
# blocks an iteration, iterations, the bound's count of instructions a
# block, None for the reduction mod L alone). A cold op runs once in a
# fresh launch, with no warm-up.
HASH_BENCH_OPS = (
    *((op, 1, 200, SHA256_COMPRESS_OPS) for op in (31, 32, 33)),
    *((op, 12, 20, SHA256_COMPRESS_OPS) for op in (34, 35)), (36, 12, 1, SHA256_COMPRESS_OPS),
    (37, 12, 20, SHA256_COMPRESS_OPS), *((op, 1, 100, SHA512_BLOCK_OPS) for op in (38, 39, 40)),
    (41, 1, 40, SHA512_BLOCK_OPS + MULS_MOD_L), (42, 1, 40, SHA512_BLOCK_OPS + MULS_MOD_L), (43, 1, 400, None),
    (44, 1, 1, SHA512_BLOCK_OPS + MULS_MOD_L),
)
HASH_BENCH_COLD = (36, 44)


def field_bench_libs(libs: dict) -> dict:
    """{label: the field bench library loaded, its entry points bound}."""
    import ctypes

    out = {}
    for label, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.field_bench_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.field_bench_run.restype = ctypes.c_int
        lib.field_bench_name.argtypes = [ctypes.c_int]
        lib.field_bench_name.restype = ctypes.c_char_p
        out[label] = lib
    return out


def hash_bench(card: str, libs: dict) -> None:
    """One warp's cycles a block (clock64(), the median of its 32 lanes) of
    each of the field bench's hash ops, for each built library ({label:
    path}): SHA-256's compression and SHA-512's block in the kernels' form
    and the forms they did not take, a 700-byte message's 12 blocks through
    one lane (the staged route alone; both routes compiled in, warm and
    cold) and through a pair of lanes (a round lane and a schedule lane), the
    challenge's lane (warm and cold) and pair on a 32-byte message (a block
    and the reduction), and the reduction mod L alone; each beside the bound's count
    of instructions a block and the instructions a cycle that makes."""
    import torch

    gen = torch.Generator().manual_seed(SEED)
    io0 = torch.randint(0, 2**31, (64 * 8,), generator=gen, dtype=torch.int64).to(torch.int32)
    cyc = torch.zeros(32, dtype=torch.int64, device="cuda")
    fns = field_bench_libs(libs)
    for op, blocks, iters, ops in HASH_BENCH_OPS:
        shown = []
        for label, lib in fns.items():
            io = io0.cuda()
            err = 0 if op in HASH_BENCH_COLD else lib.field_bench_run(io.data_ptr(), cyc.data_ptr(), op, 2, None)
            err = err or lib.field_bench_run(io.data_ptr(), cyc.data_ptr(), op, iters, None)
            if err == -1:
                shown.append(f"{label} not in this checkout")
                continue
            if err:
                raise RuntimeError(f"field_bench hash op {op} failed: CUDA error {err}")
            c = statistics.median(cyc.cpu().tolist()) / iters / blocks
            shown.append(f"{label} {c:.1f}" + (f" ({ops / c:.3f} a cycle)" if ops else ""))
        name = next(iter(fns.values())).field_bench_name(op).decode()
        count = f"{ops} instructions a block by the bound's count" if ops else f"{MULS_MOD_L} multiplies"
        log(f"[{card}] hash bench, one warp, cycles a block: {name} ({count}): " + ", ".join(shown))


# The field bench's BLS12-381 ops (csrc/field_bench.cu op codes 45-64):
# (op code, iterations). A row op's cycles are a row's: the pairing
# kernels' cost of one row of their programs (52-53 the check's, one lane
# an op on one warp; 59-64 on a group of lanes an op, 59 and 62 the
# multi-pairing's forms, 64 a row of its products and six of its sums).
BLS_BENCH_OPS = ((45, 100), (46, 200), (47, 200), (48, 400), (49, 400), (50, 100), (51, 100), (52, 100),
                 (53, 400), (54, 2), (55, 200), (56, 8), (57, 200), (58, 400), (59, 200), (60, 200), (61, 200),
                 (62, 400), (63, 400), (64, 100))
BLS_BENCH_ROW, BLS_BENCH_SUM_ROW, BLS_BENCH_INV = 52, 53, 56
BLS_BENCH_QUAD_ROW, BLS_BENCH_QUAD_SUM_ROW = 59, 62


def bls_bench(card: str, libs: dict) -> dict:
    """One warp's cycles (clock64(), the median of its 32 lanes) of each of
    the field bench's BLS12-381 ops, for each built library ({label:
    path}). Returns this checkout's {op code: cycles}."""
    import torch

    gen = torch.Generator().manual_seed(SEED)
    io0 = torch.randint(0, 2**31, (64 * 8,), generator=gen, dtype=torch.int64).to(torch.int32)
    cyc = torch.zeros(32, dtype=torch.int64, device="cuda")
    fns = field_bench_libs(libs)
    mine = {}
    for op, iters in BLS_BENCH_OPS:
        shown = []
        for label, lib in fns.items():
            io = io0.cuda()
            err = lib.field_bench_run(io.data_ptr(), cyc.data_ptr(), op, 2, None)  # warm
            err = err or lib.field_bench_run(io.data_ptr(), cyc.data_ptr(), op, iters, None)
            if err == -1:
                shown.append(f"{label} not in this checkout")
                continue
            if err:
                raise RuntimeError(f"field_bench BLS op {op} failed: CUDA error {err}")
            c = statistics.median(cyc.cpu().tolist()) / iters
            if label == "this":
                mine[op] = c
            shown.append(f"{label} {c:.1f}")
        name = next(iter(fns.values())).field_bench_name(op).decode()
        log(f"[{card}] BLS bench, one warp, cycles per {name}: " + ", ".join(shown))
    return mine


def build_field_bench(checkout: str | Path) -> Path:
    """nvcc of this checkout's csrc/field_bench.cu against `checkout`'s
    csrc/ into that checkout's build directory; returns the library."""
    from fisco_bcos_tpu_torch.ops import _kernels

    csrc = Path(checkout).resolve() / "fisco_bcos_tpu_torch" / "csrc"
    out = csrc.parent / "build" / "libfield_bench.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
         str(_kernels.CSRC / "field_bench.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for field_bench against {csrc}:\n{proc.stdout}")
    return out


def field_bench(card: str, libs: dict, tables: dict) -> None:
    """One warp's cycles (median over its 32 lanes, clock64()) per field op
    and group-law op, and per SM2 product for loop bodies of K products,
    for each built library ({label: path}); Poseidon's ops over each
    checkout's constants table ({label: tensor on the card, or None})."""
    import torch

    gen = torch.Generator().manual_seed(SEED)
    io0 = torch.randint(0, 2**31, (64 * 8,), generator=gen, dtype=torch.int64).to(torch.int32)
    cyc = torch.zeros(32, dtype=torch.int64, device="cuda")
    fns = field_bench_libs(libs)

    def cycles(label: str, op: int, iters: int) -> float | None:
        lib, table = fns[label], tables.get(label)
        ptr = None if table is None else table.data_ptr()
        io = io0.cuda()
        err = lib.field_bench_run(io.data_ptr(), cyc.data_ptr(), op, 2, ptr)  # warm
        if err == -1:
            return None  # an op this checkout's sources lack
        err = err or lib.field_bench_run(io.data_ptr(), cyc.data_ptr(), op, iters, ptr)
        if err:
            raise RuntimeError(f"field_bench op {op} failed: CUDA error {err}")
        return statistics.median(cyc.cpu().tolist()) / iters

    def show(c: float | None) -> str:
        return "not in this checkout" if c is None else f"{c:.1f}"

    labels = list(fns)
    for op in range(FIELD_BENCH_OPS):
        iters = FIELD_BENCH_ITERS.get(op, 40)
        name = fns[labels[0]].field_bench_name(op).decode()
        log(f"[{card}] field bench, one warp, cycles per {name}: "
            + ", ".join(f"{lb} {show(cycles(lb, op, iters))}" for lb in labels))
    sizes = {lb: sass_by_function(path) for lb, path in libs.items()}
    for k in BODY_SIZES:
        iters = max(8, 800 // k)

        def body(lb: str) -> str:  # the kernel's SASS size: ~its loop body
            n = next((v for f, v in sizes[lb].items() if f.startswith(f"_Z15body_size_benchILi{k}E")), 0)
            return f" ({n * 16 / 1024:.0f} KiB)" if n else ""

        log(f"[{card}] field bench, one warp, loop body of {k} SM2 products: cycles per product "
            + ", ".join(f"{lb} {cycles(lb, 100 + k, iters) / k:.1f}{body(lb)}" for lb in labels))


# ---------------------------------------------------------------------------
# The device observatory: spans, the build ledger, the plane's telemetry
# ---------------------------------------------------------------------------

OBS_HASHERS = ("keccak256", "sm3", "sha256", "poseidon")
OBS_CALLERS = 4  # 4-lane batch_verify callers merged into one plane dispatch
OBS_REPS = 5  # calls a turn of the overhead A/B, median


def run_observatory_phase(card: str) -> None:
    """The observatory in fresh interpreters (this process's ledger saw the
    startup builds): ``observatory_child("warm")`` with the libraries
    already in the build directory, then ``observatory_child("cold")`` with
    an empty one. Each prints its own lines; a failed check exits it
    non-zero, and that fails this script."""
    t0 = time.perf_counter()
    for mode in ("warm", "cold"):
        subprocess.run(
            [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.observatory_child({mode!r}))"],
            cwd=Path(__file__).resolve().parent, check=True, timeout=600,
        )
    log(f"[{card}] observatory phase: {time.perf_counter() - t0:.1f} s in two fresh interpreters")


def observatory_child(mode: str) -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the observatory phase needs the CUDA card")
    card = card_line()
    (observatory_warm if mode == "warm" else observatory_cold)(card)
    return 0


def observatory_calls(device) -> tuple[list[tuple[str, object]], tuple]:
    """(JAX op of its span, call) of each host entry point the phase drives
    once: the main path at 10,240 lanes, the other entry points, a merkle
    root a hasher, a Poseidon hash batch, a QC check and a header fold; and
    the secp256k1 block's arrays."""
    from fisco_bcos_tpu_torch.crypto import bls, suite
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch, admit_batch_sm
    from fisco_bcos_tpu_torch.ops import ed25519, merkle, secp256k1

    block = make_bench_block(BENCH_SIGNERS)
    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    hashes, rs, ss, pubs, _ = verify_arrays(verify_rows_from_block(block), BLOCK_TXS)
    sm_payloads, sigs128, _ = sm2_tile(make_sm2_bench_block(BENCH_SIGNERS), BLOCK_TXS)
    (ed_msgs, ed_pubs, ed_sigs), _ = ed25519_tile(make_ed25519_bench_block(BENCH_SIGNERS), BLOCK_TXS)
    headers, _ = make_header_checks(2, SEED + 20)
    qc = bls.BLSCrypto(device)
    poseidon = suite.Poseidon(device)
    return [
        ("admission", lambda: admit_batch(payloads, sigs65)),
        ("secp256k1_verify", lambda: secp256k1.verify_batch(hashes, rs, ss, pubs)),
        ("sm2_verify", lambda: admit_batch_sm(sm_payloads, sigs128)),
        ("ed25519_verify", lambda: ed25519.verify_batch(ed_msgs, ed_pubs, ed_sigs)),
        *[("merkle_root", lambda h=h: merkle.merkle_root(hashes, hasher=h)) for h in OBS_HASHERS],
        ("poseidon", lambda: poseidon.hash_batch(payloads)),
        ("bls_aggregate_verify", lambda: qc.aggregate_verify(*headers[0])),
        ("bls_multi_pairing", lambda: qc.multi_pairing_verify(headers)),
    ], (payloads, sigs65, hashes, rs, ss, pubs)


def obs_check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"observatory: {what}")


def observatory_warm(card: str) -> None:
    """Warm builds: every call once to load its libraries (each a
    ``cache_hit`` row, no cold build), then each once more on a clean
    ledger and trace: a ``device.<op>`` span a call, phases adding up to
    each span's wall, the ``admission`` span's execute at least the recover
    kernel's CUDA-event time; callers merged through the plane (its queue
    phase, the dispatch span over the ``device.<op>`` span, a wait record a
    caller); then the overhead A/B in turns."""
    import collections

    import numpy as np
    import torch

    from fisco_bcos_tpu_torch.crypto import suite
    from fisco_bcos_tpu_torch.device import plane as plane_mod
    from fisco_bcos_tpu_torch.device import resolve_device
    from fisco_bcos_tpu_torch.observability import TRACER
    from fisco_bcos_tpu_torch.observability import device as dev_obs
    from fisco_bcos_tpu_torch.ops import _kernels, secp256k1

    obs_check(dev_obs.install_observatory(), "install_observatory() refused")
    device = resolve_device()
    t0 = time.perf_counter()
    calls, (payloads, sigs65, hashes, rs, ss, pubs) = observatory_calls(device)
    log(f"observatory (warm builds): inputs built on the host in {time.perf_counter() - t0:.1f} s")
    for _, fn in calls:  # warm-up: every library's first use in this process
        fn()
    drain_plane()
    rows = dev_obs.LEDGER.snapshot()
    log(f"[{card}] observatory ledger after the warm-up ({len(_kernels._LIBS)} libraries loaded): "
        + json.dumps([{k: r[k] for k in ("op", "shape", "cold_compiles", "cache_hits", "compile_ms", "retrieval_ms")}
                      for r in rows]))
    obs_check(dev_obs.LEDGER.cold_compile_count() == 0, "a cold build with the libraries already built")
    obs_check(sum(r["cache_hits"] for r in rows) == len(_kernels._LIBS) == len(_kernels.SOURCES),
              "not one cache_hit a library loaded")

    dev_obs.LEDGER.reset()
    TRACER.clear()
    for _, fn in calls:
        fn()
    drain_plane()
    spans = TRACER.spans()
    got = collections.Counter(s.name for s in spans if s.name.startswith("device.") and s.name.count(".") == 1)
    want = collections.Counter(f"device.{op}" for op, _ in calls)
    obs_check(got == want, f"spans {dict(got)} != one a call {dict(want)}")
    timeline = dev_obs.LEDGER.dispatches(tail=4096)
    obs_check(len(timeline) == len(calls), f"{len(timeline)} timed spans for {len(calls)} calls")
    for op, _t0, dur, phases in timeline:
        obs_check(abs(sum(phases.values()) - dur * 1e3) <= 0.005, f"{op}: phases {phases} != wall {dur * 1e3:.3f} ms")
    span_ms = {op: phases for op, _t0, _dur, phases in timeline}
    z, r, s, v = recover_inputs(payloads, sigs65, device)
    recover_ms = cuda_ms(lambda: secp256k1.recover_device(z, r, s, v))
    rows_t = verify_row_tensor(hashes, rs, ss, pubs, device)
    verify_ms = cuda_ms(lambda: secp256k1.verify_device(rows_t))
    obs_check(span_ms["admission"]["execute"] >= recover_ms,
              f"admission execute {span_ms['admission']['execute']} ms < the recover kernel's {recover_ms:.4f}")
    log(f"[{card}] observatory spans, one a call, phases adding up to each span's wall: "
        + json.dumps({op: {k: round(v, 3) for k, v in ph.items() if v} for op, ph in span_ms.items()}))
    log(f"[{card}] span execute vs the kernel's CUDA-event time @ {BLOCK_TXS} lanes: admission "
        f"{span_ms['admission']['execute']:.3f} ms vs secp256k1_recover {recover_ms:.4f} ms; secp256k1_verify "
        f"{span_ms['secp256k1_verify']['execute']:.3f} (transfer {span_ms['secp256k1_verify'].get('transfer', 0):.3f}) "
        f"ms vs secp256k1_verify kernel {verify_ms:.4f} ms")

    # callers merged through the plane, each under a trace of its own
    lanes = 4
    plane = plane_mod.DevicePlane(window_ms=60_000, high_water=lanes * OBS_CALLERS)
    saved, plane_mod._PLANE = plane_mod._PLANE, plane
    crypto = suite.ecdsa_suite(device).signature_impl
    sigs = np.concatenate([rs[:lanes], ss[:lanes], np.zeros((lanes, 1), np.uint8)], axis=1)
    TRACER.clear()
    out = [None] * OBS_CALLERS

    def caller(i):
        with TRACER.span(f"caller{i}"):
            out[i] = crypto.batch_verify(hashes[:lanes], pubs[:lanes], sigs)

    try:
        threads = [threading.Thread(target=caller, args=(i,)) for i in range(OBS_CALLERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        obs_check(not any(t.is_alive() for t in threads) and plane.drain(60), "the plane callers did not return")
    finally:
        plane_mod._PLANE = saved
    obs_check(all(o is not None and o.all() for o in out), "a merged caller's verdicts are not all true")
    op = f"verify.secp256k1.{device}"
    spans = TRACER.spans()
    dispatch = [s_ for s_ in spans if s_.name == "device.plane.dispatch"]
    inner = [s_ for s_ in spans if s_.name == "device.secp256k1_verify"]
    waits = [s_ for s_ in spans if s_.name == "device.plane.wait"]
    obs_check(len(dispatch) == 1 and len(inner) == 1 and inner[0].parent_id == dispatch[0].span_id,
              "the dispatch span is not over one device.secp256k1_verify span")
    obs_check(len(waits) == OBS_CALLERS, f"{len(waits)} wait records for {OBS_CALLERS} callers")
    queue_ms = dev_obs.LEDGER.phase_totals()[op].get("queue", 0.0)
    obs_check(queue_ms > 0.0, "no queue phase under the plane op")
    log(f"[{card}] observatory plane: {OBS_CALLERS} callers of {lanes} lanes in {plane.stats()['dispatches']} "
        f"dispatch, queue {queue_ms:.3f} ms summed, the dispatch span over device.secp256k1_verify "
        f"({inner[0].dur * 1e3:.3f} ms), {len(waits)} wait records; adjacency {dev_obs.LEDGER.adjacency()}")
    log(f"[{card}] observatory memory: live {json.dumps(dev_obs.device_memory_bytes())} B, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; plane {json.dumps(dev_obs.device_doc()['plane'])}")
    observatory_overhead(card, calls[0][1], crypto, (hashes[:lanes], pubs[:lanes], sigs), payloads[:4], device)


def observatory_overhead(card: str, admit, crypto, verify_args, msgs, device) -> None:
    """Median host ms of `OBS_REPS` calls each of admit_batch (10,240 lanes),
    a 4-message Keccak256 hash_batch and a 4-lane batch_verify with the
    observatory, registry and tracer on, off, off, on; the µs a call they
    cost, and the ledger's own bookkeeping wall a span."""
    from fisco_bcos_tpu_torch.crypto import suite
    from fisco_bcos_tpu_torch.observability import TRACER, set_enabled
    from fisco_bcos_tpu_torch.observability import device as dev_obs

    keccak = suite.Keccak256(device)
    runs = {"admit_batch": admit, "hash_batch": lambda: keccak.hash_batch(msgs),
            "batch_verify": lambda: crypto.batch_verify(*verify_args)}
    times: dict[str, dict[str, list[float]]] = {name: {"on": [], "off": []} for name in runs}
    spans_on = 0
    overhead_on = 0.0
    try:
        for flag in (True, False, False, True):
            os.environ["FISCO_DEVICE_OBS"] = "1" if flag else "0"
            set_enabled(flag)
            before_s, before_n = dev_obs.LEDGER.overhead_seconds(), len(dev_obs.LEDGER.dispatches(tail=4096))
            for name, fn in runs.items():
                fn()  # warm
                for _ in range(OBS_REPS):
                    t0 = time.perf_counter()
                    fn()
                    times[name]["on" if flag else "off"].append((time.perf_counter() - t0) * 1e3)
            if flag:
                overhead_on += dev_obs.LEDGER.overhead_seconds() - before_s
                spans_on += len(dev_obs.LEDGER.dispatches(tail=4096)) - before_n
    finally:
        os.environ.pop("FISCO_DEVICE_OBS", None)
        set_enabled(True)
    parts = []
    for name, t in times.items():
        on, off = statistics.median(t["on"]), statistics.median(t["off"])
        parts.append(f"{name} on {on:.4f} / off {off:.4f} ms ({(on - off) * 1e3:+.1f} µs a call)")
    log(f"[{card}] observatory overhead, median of {OBS_REPS} a turn, turns on/off/off/on: " + "; ".join(parts))
    log(f"[{card}] observatory bookkeeping (LEDGER.overhead_seconds): {overhead_on * 1e6:.1f} µs over "
        f"{spans_on} spans, {overhead_on * 1e6 / max(spans_on, 1):.2f} µs a span; process total "
        f"{dev_obs.LEDGER.overhead_seconds() * 1e6:.1f} µs; trace ring holds {len(TRACER.spans())} spans")


def observatory_cold(card: str) -> None:
    """An empty build directory (assigned here, no knob of the package):
    the first keccak256_batch builds its library with nvcc, and the ledger
    holds exactly one cold row, under the span's op, with nvcc's ms."""
    import tempfile

    from fisco_bcos_tpu_torch.observability import device as dev_obs
    from fisco_bcos_tpu_torch.ops import _kernels, keccak

    with tempfile.TemporaryDirectory(prefix="obs-build-") as empty:
        _kernels.BUILD_DIR = Path(empty)
        obs_check(dev_obs.install_observatory(), "install_observatory() refused")
        t0 = time.perf_counter()
        out = keccak.keccak256_batch([b"a cold build", b"", b"x" * 300, b"y" * 136])
        wall_ms = (time.perf_counter() - t0) * 1e3
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    obs_check([bytes(d) for d in out] == [keccak256(m) for m in (b"a cold build", b"", b"x" * 300, b"y" * 136)],
              "digests of the cold call")
    rows = dev_obs.LEDGER.snapshot()
    obs_check(len(rows) == 1 and rows[0]["op"] == "keccak256" and rows[0]["cold_compiles"] == 1
              and rows[0]["cache_hits"] == 0 and rows[0]["compile_ms"] > 0.0, f"not one cold keccak256 row: {rows}")
    phases = dev_obs.LEDGER.phase_totals()["keccak256"]
    log(f"[{card}] observatory cold build (empty build directory): ledger {json.dumps(rows)}; "
        f"keccak256_batch of 4 messages {wall_ms:.1f} ms, phases {json.dumps(phases)}")


# ---------------------------------------------------------------------------
# The node's transaction pool: admission, sealing and the ledger's write
# ---------------------------------------------------------------------------

FLOOD_BATCHES = 5  # BASELINE config 4's flood at full width: 5 x 10,240 = 51,200 transactions
MIXED_BATCH = FLOOD_BATCHES - 1  # the batch that also carries every rejected kind
POOL_REPS = 5  # fresh pools a timed submit_batch
POOL_TURNS = 3  # rounds of admit_batch alone, submit_batch, submit_batch, admit_batch alone
POOL_SAMPLE = 256  # lanes a batch whose tx hash is held against the host oracle
SIGN_SAMPLE = 8  # lanes a batch whose signature is held against the host oracle
TX_LIMIT = 500  # block_limit of the flood's transactions (bench.py's)
POOL_WINDOW = 600  # the pool's replay window, TxPool's default block_limit
TRANSFER_TO = bytes.fromhex("000000000000000000000000000000000000100c")  # the DAG-transfer precompile
TRANSFER_SELECTOR = bytes.fromhex("a9059cbb")  # transfer(address,uint256)
FLOOD_NODE_SECRET = 0xF100D  # bench.py bench_flood's committee: secret 0xF100D + i
BAD_SIGNATURES = ("v=4", "r=0", "s=0", "s=n", "short", "x off the curve")
FLOOD_STAGES = ("submit_batch", "seal_txs", "txs_root", "prewrite_block", "state_hash", "merge",
                "on_block_committed")


def transfer_input(g: int) -> bytes:
    """A fixed 68-byte transfer call laid out by hand: the selector, the
    recipient's address word and the amount word."""
    return TRANSFER_SELECTOR + (0x5EED0000 + g % 4096).to_bytes(32, "big") + (1 + g % 1000).to_bytes(32, "big")


def flood_signers(kind: str) -> list[tuple[int, tuple[int, int], bytes]]:
    """The 64 signers of bench.py's admission benchmark (secret 0xBEEF +
    104729·i) or of its SM benchmark (0x1234 + 7919·i): (secret, public
    key, address by the host oracle)."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
    from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3

    curve, h, base, step = ((ref.SECP256K1, keccak256, 0xBEEF, 104729) if kind == "ecdsa"
                            else (ref.SM2_CURVE, sm3, 0x1234, 7919))
    out = []
    for i in range(BENCH_SIGNERS):
        d = base + step * i
        q = ref.privkey_to_pubkey(curve, d)
        out.append((d, q, h(q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big"))[12:]))
    return out


def off_curve_x() -> int:
    """The least x for which x³ + 7 has no square root mod p: an r that no
    recovery lifts to a point."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    p, x = ref.SECP256K1.p, 2
    while pow((x**3 + 7) % p, (p - 1) // 2, p) == 1:
        x += 1
    return x


def bad_signature(sig: bytes, kind: str) -> bytes:
    """A 65-byte signature made invalid in one of BAD_SIGNATURES' ways."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

    n = ref.SECP256K1.n
    return {
        "v=4": sig[:64] + bytes([4]),
        "r=0": bytes(32) + sig[32:],
        "s=0": sig[:32] + bytes(32) + sig[64:],
        "s=n": sig[:32] + n.to_bytes(32, "big") + sig[64:],
        "short": sig[:64],
        "x off the curve": off_curve_x().to_bytes(32, "big") + sig[32:64] + bytes([0]),
    }[kind]


class FloodBatch:
    """One 10,240-transaction batch of the flood as wire bytes, and what the
    pool must give each lane: ``want`` (tx hash, status, sender). The
    signatures share one ephemeral k a batch (test data only: each is a few
    modular products on the host instead of a whole signing); every lane is
    still recovered in full on the card. The tx hashes are the packed hash
    kernel's digests of the payloads, sampled against the host oracle."""

    def __init__(self, kind: str, b: int, device, signers, head: int = 0):
        import numpy as np

        from fisco_bcos_tpu_torch.ops import keccak, sm2, sm3
        from fisco_bcos_tpu_torch.protocol import Transaction
        from fisco_bcos_tpu_torch.utils.error import ErrorCode as E

        n = BLOCK_TXS
        mixed = kind == "ecdsa" and b == MIXED_BATCH
        self.kind, self.rng = kind, random.Random(SEED + 22 * (b + 1) + (kind == "sm"))
        txs, status, self.who, self.bad = [], [], [], {}
        for i in range(n):
            g = b * n + i
            nonce, chain, group, limit, st = f"{kind}-flood-{g}", "chain0", "group0", TX_LIMIT, E.SUCCESS
            if mixed and i % 16 == 3:  # the nonce of the lane before it: an intra-batch replay
                nonce, st = f"{kind}-flood-{g - 1}", E.ALREADY_IN_TX_POOL
            elif mixed and i % 256 == 5:
                chain, st = "chain1", E.INVALID_CHAIN_ID
            elif mixed and i % 256 == 6:
                group, st = "group1", E.INVALID_GROUP_ID
            elif mixed and i % 256 == 7:  # expired: at the head
                limit, st = head, E.BLOCK_LIMIT_CHECK_FAIL
            elif mixed and i % 256 == 8:  # beyond the head's window
                limit, st = head + POOL_WINDOW + 1, E.BLOCK_LIMIT_CHECK_FAIL
            elif mixed and i % 16 == 1:  # a sixteenth of the signatures
                st, self.bad[i] = E.INVALID_SIGNATURE, BAD_SIGNATURES[(i // 16) % len(BAD_SIGNATURES)]
            txs.append(Transaction(version=1, chain_id=chain, group_id=group, block_limit=limit, nonce=nonce,
                                   to=TRANSFER_TO, input=transfer_input(g), import_time=1_700_000_000_000 + g))
            status.append(int(st))
            self.who.append(g % BENCH_SIGNERS)
        self.payloads = [t.encode_data() for t in txs]
        digests = (keccak.keccak256_batch if kind == "ecdsa" else sm3.sm3_batch)(self.payloads, device)
        self.hashes = [bytes(d) for d in digests]
        if kind == "ecdsa":
            sigs = self._sign_ecdsa(signers)
        else:
            pubs = np.frombuffer(b"".join(_xy(q) for _, q, _ in signers), dtype=np.uint8).reshape(-1, 64)
            self.e = sm2.sm2_e_batch(digests, pubs[self.who], device=device)
            sigs = self._sign_sm2(signers)
        for i, how in self.bad.items():
            sigs[i] = bad_signature(sigs[i], how)
        for t, s in zip(txs, sigs):
            t.signature = s
        self.sigs = sigs
        self.wires = [t.encode() for t in txs]
        self.want = [(h, st, signers[w][2] if st == E.SUCCESS else b"")
                     for h, st, w in zip(self.hashes, status, self.who)]

    def _sign_ecdsa(self, signers) -> list[bytes]:
        from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

        c = ref.SECP256K1
        k = self.rng.randrange(1, c.n)
        rx, ry = ref.point_mul(c, k, (c.gx, c.gy))
        if rx >= c.n:  # v would need its overflow bit: another k
            raise AssertionError(f"flood nonce k gives R.x >= n (seed {SEED})")
        kinv, r, v = pow(k, -1, c.n), rx.to_bytes(32, "big"), bytes([ry & 1])
        return [r + (kinv * (int.from_bytes(h, "big") + rx * signers[w][0]) % c.n).to_bytes(32, "big") + v
                for h, w in zip(self.hashes, self.who)]

    def _sign_sm2(self, signers) -> list[bytes]:
        from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

        c = ref.SM2_CURVE
        k = self.rng.randrange(1, c.n)
        x1 = ref.point_mul(c, k, (c.gx, c.gy))[0]
        inv = [pow(1 + d, -1, c.n) for d, _, _ in signers]
        out = []
        for e, w in zip(self.e, self.who):
            r = (int.from_bytes(bytes(e), "big") + x1) % c.n
            s = inv[w] * (k - r * signers[w][0]) % c.n
            if not r or r + k == c.n or not s:
                raise AssertionError("a degenerate SM2 flood signature (r = 0, r + k = n or s = 0)")
            out.append(r.to_bytes(32, "big") + s.to_bytes(32, "big") + _xy(signers[w][1]))
        return out

    def check_signatures(self, signers) -> None:
        """A sample of the signatures, and one of each bad kind, against
        the host oracle's recovery or verification."""
        from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref

        good = [i for i in range(len(self.sigs)) if i not in self.bad]
        for i in self.rng.sample(good, SIGN_SAMPLE) + [min(k for k, v in self.bad.items() if v == how)
                                                       for how in set(self.bad.values())]:
            sig, q = self.sigs[i], signers[self.who[i]][1]
            r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big")
            if self.kind == "ecdsa":
                valid_v = len(sig) == 65 and sig[64] in (0, 1, 2, 3, 27, 28)  # the device's rule
                got = ref.ecdsa_recover(self.hashes[i], r, s, sig[64]) if valid_v else None
                ok = got == q
            else:
                ok = ref.sm2_verify_e(ref.sm2_e(self.hashes[i], q), r, s, q)
                if ok and ref.sm2_e(self.hashes[i], q) != int.from_bytes(bytes(self.e[i]), "big"):
                    raise AssertionError(f"sm2_e_batch != host oracle on SM flood lane {i}")
            if ok != (i not in self.bad):
                raise AssertionError(f"flood lane {i} ({self.bad.get(i, 'valid')}): host oracle says {ok}")

    def fresh(self) -> list:
        """The batch decoded from its wire bytes, as RPC and gossip deliver
        it: no hash cached, no sender."""
        from fisco_bcos_tpu_torch.protocol import Transaction

        return [Transaction.decode(w) for w in self.wires]


def _xy(q) -> bytes:
    return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def _ref_hash(hasher: str):
    """The port's host oracle of a hash, by name."""
    if hasher == "keccak256":
        from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

        return keccak256
    if hasher == "sha256":
        from fisco_bcos_tpu_torch.crypto.ref.sha2 import sha256

        return sha256
    from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3

    return sm3


def oracle_digests(job: tuple[str, list[bytes]]) -> list[bytes]:
    """The host oracle's digest of each message (an oracle pool job)."""
    h = _ref_hash(job[0])
    return [h(m) for m in job[1]]


def oracle_xor(job: tuple[str, list[bytes]]) -> int:
    """The XOR of the host oracle's digests of the messages, as an integer
    (an oracle pool job: a share of the state hash)."""
    h, acc = _ref_hash(job[0]), 0
    for m in job[1]:
        acc ^= int.from_bytes(h(m), "big")
    return acc


def oracle_root(job: tuple[str, bytes]) -> bytes:
    """oracle_merkle_root of packed 32-byte leaves (an oracle pool job)."""
    leaves = job[1]
    return oracle_merkle_root([leaves[i:i + 32] for i in range(0, len(leaves), 32)], job[0])


def state_preimages(overlay) -> list[bytes]:
    """H's inputs of the overlay's state hash, one a dirty row: flat(table)
    ‖ flat(key) ‖ the entry's bytes (storage/state_storage.py)."""
    from fisco_bcos_tpu_torch.codec.flat import FlatWriter

    out = []
    for t, k, e in overlay.traverse():
        out.append(FlatWriter().str_(t).bytes_(k).out() + e.encode())
    return out


class PoolOracle:
    """Host-oracle jobs gathered while the phase runs and sent to the oracle
    pool once its timed parts are over (so the workers do not share the
    host with them); ``settle`` waits and holds each result."""

    def __init__(self):
        self.jobs = []  # (what, kind of job, job, expected)

    def digests(self, what: str, hasher: str, msgs, want) -> None:
        self.jobs.append((what, "digests", (hasher, list(msgs)), list(want)))

    def root(self, what: str, hasher: str, leaves: list[bytes], want: bytes) -> None:
        self.jobs.append((what, "root", (hasher, b"".join(leaves)), want))

    def state(self, what: str, hasher: str, preimages: list[bytes], want: bytes) -> None:
        self.jobs.append((what, "state", (hasher, preimages), want))

    def settle(self, card: str, pool) -> None:
        t0 = time.perf_counter()
        futures = []
        for what, how, job, want in self.jobs:
            if how == "state":
                chunk = max(1, len(job[1]) // (4 * ORACLE_WORKERS))
                parts = [pool.submit(oracle_xor, (job[0], job[1][i:i + chunk]))
                         for i in range(0, len(job[1]), chunk)]
            else:
                parts = [pool.submit(oracle_digests if how == "digests" else oracle_root, job)]
            futures.append((what, how, parts, want))
        for what, how, parts, want in futures:
            got = [f.result() for f in parts]
            if how == "state":
                acc = 0
                for x in got:
                    acc ^= x
                got = acc.to_bytes(32, "big")
            else:
                got = got[0]
            if got != want:
                raise AssertionError(f"{what} != host oracle")
        log(f"[{card}] txpool phase: {len(self.jobs)} host-oracle checks held (tx hash samples, every txs root "
            f"and state hash) in {time.perf_counter() - t0:.1f} s on {ORACLE_WORKERS} workers")


def txpool_genesis(suite, kind: str):
    """A MemoryStorage, its Ledger and the genesis header of a four-node
    committee (chain0/group0, tx_count_limit one block of BLOCK_TXS)."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.ledger import ConsensusNode, GenesisConfig, Ledger
    from fisco_bcos_tpu_torch.storage import MemoryStorage

    curve = ref.SECP256K1 if kind == "ecdsa" else ref.SM2_CURVE
    nodes = [_xy(ref.privkey_to_pubkey(curve, FLOOD_NODE_SECRET + i)) for i in range(4)]
    store = MemoryStorage()
    ledger = Ledger(store, suite)
    ledger.build_genesis(GenesisConfig(consensus_nodes=[ConsensusNode(p) for p in nodes], tx_count_limit=BLOCK_TXS,
                                       timestamp=1_700_000_000_000))
    return store, ledger, nodes


def new_pool(suite, ledger):
    from fisco_bcos_tpu_torch.txpool import TxPool
    from fisco_bcos_tpu_torch.txpool.quota import AdmissionQuotas

    return TxPool(suite, ledger, quotas=AdmissionQuotas())


def submit_checked(pool, batch: FloodBatch, launches: dict, what: str):
    """pool.submit_batch of the batch decoded from its wire bytes, counted
    (counted_run): every lane's (tx hash, status, sender) as the batch
    wants it. Returns (results, wall ms)."""
    txs = batch.fresh()
    t0 = time.perf_counter()
    results, _ = counted_run(lambda: pool.submit_batch(txs), launches, what)
    ms = (time.perf_counter() - t0) * 1e3
    got = [(r.tx_hash, int(r.status), r.sender) for r in results]
    if got != batch.want:
        bad = next(i for i, (g, w) in enumerate(zip(got, batch.want)) if g != w)
        raise AssertionError(f"{what}: lane {bad} gave {got[bad]}, not {batch.want[bad]}")
    return results, ms


def write_block(pool, ledger, store, suite, nodes, hasher: str, oracle: PoolOracle, what: str) -> dict:
    """Seal one block of the pool's txs and write it as the node does: the
    txs root on the card, prewrite_block into an overlay, its state hash on
    the card, merge_into_prev, on_block_committed. Returns each stage's ms
    and the block's hashes; the root and the state hash go to the oracle."""
    from fisco_bcos_tpu_torch.protocol import Block, BlockHeader, ParentInfo
    from fisco_bcos_tpu_torch.storage import StateStorage

    ms = {}
    number = ledger.block_number() + 1
    t0 = time.perf_counter()
    txs, hashes = pool.seal_txs(ledger.ledger_config().tx_count_limit)
    ms["seal_txs"] = (time.perf_counter() - t0) * 1e3
    block = Block(header=BlockHeader(
        version=1, parent_info=[ParentInfo(number - 1, ledger.block_hash_by_number(number - 1))], number=number,
        timestamp=1_700_000_000_000 + number, sealer=number % 4, sealer_list=list(nodes), consensus_weights=[1] * 4,
    ), transactions=txs)
    t0 = time.perf_counter()
    root, _ = counted_run(lambda: block.calculate_txs_root(suite), {f"{hasher}_packed": tree_levels(len(txs))},
                          f"{what}'s txs root")
    ms["txs_root"] = (time.perf_counter() - t0) * 1e3
    block.header.txs_root = root
    overlay = StateStorage(prev=store)
    t0 = time.perf_counter()
    ledger.prewrite_block(block, overlay)
    ms["prewrite_block"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state, _ = counted_run(lambda: overlay.hash(suite), {f"{hasher}_packed": 1}, f"{what}'s state hash")
    ms["state_hash"] = (time.perf_counter() - t0) * 1e3
    oracle.root(f"{what}'s txs root", hasher, hashes, root)
    oracle.state(f"{what}'s state hash", hasher, state_preimages(overlay), state)
    t0 = time.perf_counter()
    overlay.merge_into_prev()
    ms["merge"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pool.on_block_committed(number, hashes)
    ms["on_block_committed"] = (time.perf_counter() - t0) * 1e3
    if ledger.block_number() != number or ledger.header_by_number(number).txs_root != root:
        raise AssertionError(f"{what} was not written as block {number}")
    k = len({t.sender for t in txs})  # round-robin: the first k sealed come from the k senders
    if len({t.sender for t in txs[:k]}) != k:
        raise AssertionError(f"{what}: seal_txs did not go round its {k} senders")
    return {"ms": ms, "hashes": hashes, "txs": len(txs)}


def run_flood(card: str, suite, batches: list[FloodBatch], oracle: PoolOracle) -> dict:
    """The flood: each batch submitted to one pool, then a block of it
    sealed and written, in turn; every lane's result held against the
    batch's expectation, each submit_batch counted (one admit_batch's
    launches), each root and state hash counted and sent to the oracle."""
    import gc

    store, ledger, nodes = txpool_genesis(suite, "ecdsa")
    pool = new_pool(suite, ledger)
    stages = {k: [] for k in FLOOD_STAGES}
    written = 0
    full_collections = gc.get_stats()[2]["collections"]
    for b, batch in enumerate(batches):
        if ledger.block_number() != b:
            raise AssertionError(f"flood batch {b} submitted at head {ledger.block_number()}")
        results, ms = submit_checked(pool, batch, ADMIT_LAUNCHES, f"TxPool.submit_batch of flood batch {b}")
        stages["submit_batch"].append(ms)
        admitted = {r.tx_hash for r in results if r.status == 0}
        block = write_block(pool, ledger, store, suite, nodes, "keccak256", oracle, f"flood block {b + 1}")
        if set(block["hashes"]) != admitted or pool.pending_count():
            raise AssertionError(f"flood block {b + 1} is not batch {b}'s admitted transactions")
        for k, v in block["ms"].items():
            stages[k].append(v)
        written += block["txs"]
    flood_ms = sum(sum(v) for v in stages.values())
    full_collections = gc.get_stats()[2]["collections"] - full_collections
    statuses = {}
    for _, st, _ in batches[MIXED_BATCH].want:
        statuses[st] = statuses.get(st, 0) + 1
    log(f"[{card}] txpool flood: {sum(len(b.wires) for b in batches)} transactions in {len(batches)} batches of "
        f"{BLOCK_TXS}, {written} written in {len(batches)} blocks; the mixed batch's statuses "
        f"{json.dumps(statuses)} (bad signatures: {', '.join(BAD_SIGNATURES)}); every lane's tx hash, status "
        f"and sender as built; each submit_batch {show_launches(ADMIT_LAUNCHES)}")
    log(f"[{card}] txpool flood, submitted to written: {flood_ms:.1f} ms, {written / flood_ms * 1e3:.0f} tx/s "
        f"(wire decode excluded; {full_collections} full garbage collections meanwhile); a stage, median of "
        f"the {len(batches)} blocks (ms, each block): "
        + "; ".join(f"{k} {statistics.median(v):.3f} ({', '.join(f'{x:.2f}' for x in v)})"
                    for k, v in stages.items()))
    return {"store": store, "ledger": ledger, "pool": pool, "stages": stages, "flood_ms": flood_ms,
            "written": written}


def pool_stages(suite, ledger, batch: FloodBatch) -> dict[str, float]:
    """submit_batch's stages one at a time on fresh objects (median of 3):
    the static gates (check_static and the batch's nonce set), the payload
    encode, batch_admit, and the results and inserts."""
    from fisco_bcos_tpu_torch.txpool.txpool import TxSubmitResult
    from fisco_bcos_tpu_torch.txpool.validator import batch_admit
    from fisco_bcos_tpu_torch.utils.error import ErrorCode

    out = {}

    def timed(name, prepare, fn):
        times = []
        for _ in range(3):
            arg = prepare()
            t0 = time.perf_counter()
            fn(arg)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)

    def static(arg):
        pool, txs = arg
        seen = set()
        for tx in txs:
            if pool.validator.check_static(tx) == ErrorCode.SUCCESS and tx.nonce not in seen:
                seen.add(tx.nonce)

    def inserts(arg):
        pool, txs = arg
        for tx in txs:
            h = tx.hash(suite)
            pool._insert(tx, h, persist=False)
            TxSubmitResult(h, ErrorCode.SUCCESS, tx.sender)

    def admitted():
        txs = batch.fresh()
        batch_admit(txs, suite)
        return new_pool(suite, ledger), txs

    timed("static gates", lambda: (new_pool(suite, ledger), batch.fresh()), static)
    timed("payload encode", batch.fresh, lambda txs: [t.encode_data() for t in txs])
    timed("batch_admit", batch.fresh, lambda txs: batch_admit(txs, suite))
    timed("results and inserts", admitted, inserts)
    return out


def time_pool(card: str, suite, batch: FloodBatch) -> dict:
    """submit_batch of one 10,240-tx batch into fresh pools (a warm call,
    then the median of POOL_REPS), its stages, admit_batch of the same
    payloads and signatures alone in turns with it, and one profiled call."""
    import numpy as np

    from fisco_bcos_tpu_torch.crypto.admission import admit_batch

    _, ledger, _ = txpool_genesis(suite, "ecdsa")

    def submit(txs=None):
        txs = batch.fresh() if txs is None else txs
        pool = new_pool(suite, ledger)
        t0 = time.perf_counter()
        pool.submit_batch(txs)
        return (time.perf_counter() - t0) * 1e3

    submit()
    reps = [submit() for _ in range(POOL_REPS)]
    submit_ms = statistics.median(reps)
    stages = pool_stages(suite, ledger, batch)
    sigs = np.frombuffer(b"".join(batch.sigs), dtype=np.uint8).reshape(-1, 65)

    def alone():
        t0 = time.perf_counter()
        admit_batch(batch.payloads, sigs, device=suite.device)
        return (time.perf_counter() - t0) * 1e3

    alone()
    turns = {"admit_batch alone": [], "submit_batch": []}
    for _ in range(POOL_TURNS):
        for who in ("admit_batch alone", "submit_batch", "submit_batch", "admit_batch alone"):
            turns[who].append(alone() if who == "admit_batch alone" else submit())
    log(f"[{card}] TxPool.submit_batch @ {BLOCK_TXS} txs into a fresh pool, median of {POOL_REPS}: {submit_ms:.2f} ms "
        f"({BLOCK_TXS / submit_ms * 1e3:.0f} tx/s; each {', '.join(f'{x:.2f}' for x in reps)})")
    log(f"[{card}] TxPool.submit_batch stages, one at a time, median of 3 (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log(f"[{card}] admit_batch alone and submit_batch on the same {BLOCK_TXS} transactions, in turns (ms): "
        + "; ".join(f"{k} median {statistics.median(v):.3f} ({', '.join(f'{x:.2f}' for x in v)})"
                    for k, v in turns.items())
        + f"; the pool adds {statistics.median(turns['submit_batch']) - statistics.median(turns['admit_batch alone']):.3f}")
    ready = [batch.fresh() for _ in range(4)]  # profiled_events makes a warm call and three traced ones
    log_busy(card, f"TxPool.submit_batch @ {BLOCK_TXS} txs", lambda: submit(ready.pop() if ready else None))
    return {"submit_ms": submit_ms, "stages": stages, "turns": turns}


def run_sm_pool(card: str, device, oracle: PoolOracle) -> None:
    """One 10,240-tx batch of the SM suite (bench_sm2's 64 signers) through
    an SM pool and into a block, checked as the flood is: every lane's
    tx hash, status and sender, admit_batch_sm's launches, the block's SM3
    txs root and state hash against the host oracle."""
    from fisco_bcos_tpu_torch.crypto.suite import sm_suite

    suite = sm_suite(device)
    signers = flood_signers("sm")
    batch = FloodBatch("sm", 0, device, signers)
    batch.check_signatures(signers)
    oracle.digests("SM tx hash sample", "sm3", *zip(*batch.rng.sample(
        list(zip(batch.payloads, batch.hashes)), POOL_SAMPLE)))
    store, ledger, nodes = txpool_genesis(suite, "sm")
    pool = new_pool(suite, ledger)
    _, ms = submit_checked(pool, batch, ADMIT_SM_LAUNCHES, "the SM pool's submit_batch")
    block = write_block(pool, ledger, store, suite, nodes, "sm3", oracle, "the SM block")
    log(f"[{card}] SM pool: submit_batch @ {BLOCK_TXS} txs {ms:.2f} ms (one call, counted: "
        f"{show_launches(ADMIT_SM_LAUNCHES)}), every lane's tx hash, status and sender as built; its block of "
        f"{block['txs']} written (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in block["ms"].items()))


def run_txpool_phase(card: str, device) -> dict:
    """The node's transaction pool on the card (``fisco_bcos_tpu_torch/txpool``
    over the port's ledger and storage): BASELINE config 4's flood of
    51,200 parallel-transfer transactions (5 batches of 10,240 from
    bench.py's 64 signers, one batch also carrying every rejected kind),
    each batch admitted by TxPool.submit_batch and sealed into a 10,240-tx
    block that the Ledger writes; a replay of a committed batch (no launch);
    submit_batch's time, stages and device-busy share beside admit_batch
    alone; one SM batch through an SM pool; every root and state hash and a
    sample of tx hashes against the host oracle at the end."""
    from fisco_bcos_tpu_torch.crypto.suite import ecdsa_suite
    from fisco_bcos_tpu_torch.utils.error import ErrorCode

    t0 = time.perf_counter()
    suite = ecdsa_suite(device)
    signers = flood_signers("ecdsa")
    batches = [FloodBatch("ecdsa", b, device, signers, head=b) for b in range(FLOOD_BATCHES)]
    oracle = PoolOracle()
    for b, batch in enumerate(batches):
        batch.check_signatures(signers)
        oracle.digests(f"flood batch {b}'s tx hash sample", "keccak256",
                       *zip(*batch.rng.sample(list(zip(batch.payloads, batch.hashes)), POOL_SAMPLE)))
    log(f"[{card}] txpool phase: {FLOOD_BATCHES * BLOCK_TXS} transactions built and signed in "
        f"{time.perf_counter() - t0:.1f} s")
    flood = run_flood(card, suite, batches, oracle)
    t1 = time.perf_counter()
    replay, _ = counted_run(lambda: flood["pool"].submit_batch(batches[0].fresh()), {}, "a committed batch's replay")
    replay_ms = (time.perf_counter() - t1) * 1e3
    if [(r.tx_hash, r.status) for r in replay] != [(h, ErrorCode.TX_ALREADY_IN_CHAIN) for h, _, _ in batches[0].want]:
        raise AssertionError("a committed batch's replay did not give TX_ALREADY_IN_CHAIN on every lane")
    log(f"[{card}] replay of committed flood batch 0: TX_ALREADY_IN_CHAIN on all {BLOCK_TXS} lanes, no kernel "
        f"launched, {replay_ms:.1f} ms (each rejected lane hashed singly on the host)")
    timed = time_pool(card, suite, batches[0])
    with oracle_pool() as pool:
        run_sm_pool(card, device, oracle)
        oracle.settle(card, pool)
    log(f"[{card}] txpool phase: {time.perf_counter() - t0:.1f} s")
    return {**timed, "flood_ms": flood["flood_ms"], "written": flood["written"], "stages": flood["stages"]}


# ---------------------------------------------------------------------------
# PBFT consensus: a four-replica committee agrees on a 10,240-tx block
# ---------------------------------------------------------------------------

CONSENSUS_BATCH = FLOOD_BATCHES  # the flood batch index of the round's block (past the txpool phase's)
CONSENSUS_ROUNDS = 3  # rounds a QC mode, each on a fresh committee, the first counted: the wall's median
CONSENSUS_MODES = (  # (label, environment) of each round's QC mode
    ("Ed25519 QC", {"FISCO_QC_SCHEME": "ed25519"}),
    ("BLS QC", {"FISCO_QC_SCHEME": "bls"}),
    ("FISCO_QC=0", {"FISCO_QC": "0"}),
)
CONSENSUS_KERNELS = {  # kernels a round must launch in each mode (the txs roots; the quorum checks)
    "Ed25519 QC": {"keccak256_packed", "ed25519_challenge", "ed25519_verify"},
    "BLS QC": {"keccak256_packed", "bls12_381_pairing"},
    "FISCO_QC=0": {"keccak256_packed"},
}
REPROPOSAL_KERNELS = {"keccak256_packed", "keccak256_tx_hash", "keccak256_sender", "secp256k1_recover",
                      "ed25519_challenge", "ed25519_verify"}
CONSENSUS_SPANS = ("pbft.pre_prepare", "pbft.prepare", "pbft.commit", "pbft.checkpoint",
                   "pbft.execute_and_checkpoint", "pbft.checkpoint_commit")
CONSENSUS_HISTOGRAMS = ("fisco_pbft_preprepare_gate_latency_ms", "fisco_pbft_prepare_latency_ms",
                        "fisco_pbft_commit_latency_ms", "fisco_pbft_execute_latency_ms",
                        "fisco_pbft_checkpoint_latency_ms", "fisco_qc_verify_ms")
HOST_PROFILE_TOP = 6  # functions of the host-profiled round printed, by own time
TAMPERED = ("a flipped signature", "a forged bitmap", "a short weight", "a wrong sealer list")
BIG_COMMITTEE = 64  # bench_scenario.big-committee.json's committee
BIG_BAD = 17  # the member whose vote signs another message
QC_TURNS = 3  # rounds of plane, direct, direct, plane a QC check
REPROPOSAL_TURNS = 3  # rounds of admit_batch alone, batch_admit, batch_admit, admit_batch alone


class StandIn:
    """Execution's stand-in in the consensus phase and in the consensus
    tests, the drivers' and never the package's (it goes when the scheduler
    is ported): the scheduler interface the engine and sealer call.
    ``execute_block`` executes nothing and returns the proposal's header as
    the sealer built it; ``commit_block`` writes the block through the
    replica's ``Ledger`` as the txpool phase writes a flood block (prewrite
    into an overlay, merge) and tells the pool. `classes`: the package's
    (BlockHeader, Block, StateStorage), the port's by default."""

    def __init__(self, suite, store, ledger, pool, classes=None):
        if classes is None:
            from fisco_bcos_tpu_torch.protocol import Block, BlockHeader
            from fisco_bcos_tpu_torch.storage import StateStorage

            classes = (BlockHeader, Block, StateStorage)
        self.suite, self.store, self.ledger, self.pool = suite, store, ledger, pool
        self.BlockHeader, self.Block, self.StateStorage = classes
        self.executed = {}

    def execute_block(self, block, lazy_roots=False):
        self.executed[block.header.number] = block
        return self.BlockHeader.decode(block.header.encode())

    def commit_block(self, header) -> None:
        block = self.Block(header=header, transactions=list(self.executed.pop(header.number).transactions))
        overlay = self.StateStorage(prev=self.store)
        self.ledger.prewrite_block(block, overlay)
        overlay.merge_into_prev()
        self.pool.on_block_committed(header.number, block.tx_hashes(self.suite))

    def commit_block_async(self, header, on_done) -> None:
        self.commit_block(header)
        on_done(header.number, None)

    def in_flight_commits(self) -> int:
        return 0

    def staged_state(self, number):
        return None


@contextlib.contextmanager
def qc_mode(env: dict):
    """The QC mode's environment (FISCO_QC, FISCO_QC_SCHEME) while open."""
    saved = {k: os.environ.get(k) for k in ("FISCO_QC", "FISCO_QC_SCHEME")}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def consensus_committee(suite, batch: FloodBatch, auto: bool = True) -> tuple:
    """BASELINE config 4's committee (bench.py bench_flood's keys): four
    replicas, each a Ledger over its own MemoryStorage genesis (each
    member's QC key of the mode's scheme registered), a TxPool holding the
    batch, a PBFTEngine with a ConsensusStorage over that store, a Sealer
    and the stand-in, all over one InprocGateway. Returns (gateway,
    replicas)."""
    import types

    from fisco_bcos_tpu_torch.consensus import PBFTConfig, PBFTEngine, Sealer
    from fisco_bcos_tpu_torch.consensus.qc import qc_pub_for, qc_scheme_name
    from fisco_bcos_tpu_torch.consensus.storage import ConsensusStorage
    from fisco_bcos_tpu_torch.front import FrontService, InprocGateway
    from fisco_bcos_tpu_torch.ledger import ConsensusNode, GenesisConfig, Ledger
    from fisco_bcos_tpu_torch.storage import MemoryStorage
    from fisco_bcos_tpu_torch.utils.error import ErrorCode

    kps = [suite.signature_impl.generate_keypair(secret=FLOOD_NODE_SECRET + i) for i in range(4)]
    members = [ConsensusNode(kp.pub, weight=1, qc_pub=qc_pub_for(kp.secret, qc_scheme_name())) for kp in kps]
    gw = InprocGateway(auto=auto)
    reps = []
    for kp in kps:
        store = MemoryStorage()
        ledger = Ledger(store, suite)
        ledger.build_genesis(GenesisConfig(consensus_nodes=list(members), tx_count_limit=BLOCK_TXS,
                                           timestamp=1_700_000_000_000))
        pool = new_pool(suite, ledger)
        if any(r.status != ErrorCode.SUCCESS for r in pool.submit_batch(batch.fresh())):
            raise AssertionError("the consensus batch was not admitted whole")
        front = FrontService(kp.pub)
        gw.connect(front)
        cfg = ledger.ledger_config()
        config = PBFTConfig(suite=suite, keypair=kp, nodes=cfg.consensus_nodes, leader_period=cfg.leader_period,
                            head=ledger.block_number())
        engine = PBFTEngine(config, StandIn(suite, store, ledger, pool), pool, ledger, front,
                            consensus_storage=ConsensusStorage(store))
        reps.append(types.SimpleNamespace(keypair=kp, store=store, ledger=ledger, pool=pool, front=front,
                                          config=config, engine=engine, sealer=Sealer(config, pool, ledger, engine)))
    return gw, reps


def round_leader(reps, number: int = 1, view: int = 0):
    nid = reps[0].config.nodes[reps[0].config.leader_index(number, view)].node_id
    return next(r for r in reps if r.keypair.pub == nid)


def path_counted(fn, must: set, what: str):
    """`fn()` with every launch counter set to 0 just before and read just
    after, no plain version allowed: each kernel of `must` launched at least
    once, no other kernel at all. Returns (fn's result, the nonzero counts)."""
    from fisco_bcos_tpu_torch.ops import _kernels

    drain_plane()
    _kernels.reset_launches()
    with plain_versions_forbidden():
        out = fn()
    launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    if set(launches) != must:
        raise AssertionError(f"{what} launched {launches}, not each of {sorted(must)} and nothing else")
    return out, launches


def stable_round(reps, what: str) -> dict:
    """One round, inline dispatch: the leader seals the pool's 10,240 txs
    into a metadata proposal and submits it; when submit_proposal returns,
    every replica must have stable-committed block 1. Returns the seal and
    round ms and the engine's pbft.* spans (ms)."""
    from fisco_bcos_tpu_torch.observability import TRACER

    lead = round_leader(reps)
    t0 = time.perf_counter()
    block = lead.sealer.generate_proposal()
    seal_ms = (time.perf_counter() - t0) * 1e3
    if block is None or len(block.tx_metadata) != BLOCK_TXS:
        raise AssertionError(f"{what}: the leader sealed no {BLOCK_TXS}-tx proposal")
    TRACER.clear()
    t0 = time.perf_counter()
    if not lead.engine.submit_proposal(block):
        raise AssertionError(f"{what}: the leader's proposal was refused")
    round_ms = (time.perf_counter() - t0) * 1e3
    spans = {}
    for rec in TRACER.spans():
        if rec.name in CONSENSUS_SPANS:
            spans.setdefault(rec.name, []).append(rec.dur * 1e3)
    check_stable(reps, what)
    return {"seal_ms": seal_ms, "round_ms": round_ms, "spans": spans}


def check_stable(reps, what: str, number: int = 1) -> None:
    """Every replica at `number`, on one header hash, its pool empty."""
    heads = {r.ledger.block_number() for r in reps}
    hashes = {r.ledger.block_hash_by_number(number) for r in reps}
    if heads != {number} or len(hashes) != 1 or any(r.pool.pending_count() for r in reps):
        raise AssertionError(f"{what}: heads {heads}, {len(hashes)} hashes at {number}")


def check_record(suite, header, nodes, what: str) -> str:
    """The header's QC record or signature list under the crypto/ref
    oracles: every signature over the header hash by the member it names,
    a quorum's weight. Returns the record's kind."""
    from fisco_bcos_tpu_torch.consensus.config import min_quorum
    from fisco_bcos_tpu_torch.consensus.qc import QuorumCert
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref_bls
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref_ed

    h = header.hash(suite)
    quorum = min_quorum(len(nodes))
    if header.qc:
        cert = QuorumCert.decode(header.qc)
        idx = cert.signers()
        if cert.scheme == "ed25519":
            ok = all(ref_ed.verify(nodes[i].qc_pub, h, cert.agg_sig[64 * k:64 * k + 64]) for k, i in enumerate(idx))
        else:
            ok = ref_bls.aggregate_verify([nodes[i].qc_pub for i in idx], h, cert.agg_sig)
        kind = f"{cert.scheme} QC of {len(idx)}"
    else:
        idx = [s.index for s in header.signature_list]
        ok = all(ref.ecdsa_verify(h, int.from_bytes(s.signature[:32], "big"), int.from_bytes(s.signature[32:64], "big"),
                                  (int.from_bytes(nodes[s.index].node_id[:32], "big"),
                                   int.from_bytes(nodes[s.index].node_id[32:], "big")))
                 for s in header.signature_list)
        kind = f"signature list of {len(idx)}"
    if not ok or len(set(idx)) < quorum:
        raise AssertionError(f"{what}: the {kind} does not verify under the host oracle")
    return kind


def tampered(header) -> dict:
    """The header with a flipped signature, a forged bitmap (a QC naming
    other signers than its signatures', a signature list with two members'
    indices swapped), a weight short of the quorum, and a wrong sealer
    list."""
    from fisco_bcos_tpu_torch.consensus.qc import QuorumCert
    from fisco_bcos_tpu_torch.protocol import BlockHeader, SignatureTuple

    out = {k: BlockHeader.decode(header.encode()) for k in TAMPERED}
    if header.qc:
        cert = QuorumCert.decode(header.qc)
        idx = cert.signers()
        flip = bytearray(cert.agg_sig)
        flip[len(flip) // 2] ^= 1
        out["a flipped signature"].qc = QuorumCert(cert.scheme, cert.committee, cert.bitmap, bytes(flip)).encode()
        absent = [i for i in range(cert.committee) if i not in idx]
        if absent:  # a member who did not sign in the place of one who did
            forged, agg = idx[:-1] + absent[:1], cert.agg_sig
        elif cert.scheme == "ed25519":  # everyone signed: the first three signatures, named one member on
            forged, agg = idx[1:], cert.agg_sig[:64 * (len(idx) - 1)]
        else:  # everyone signed: the aggregate of all, named as one fewer
            forged, agg = idx[:-1], cert.agg_sig
        out["a forged bitmap"].qc = QuorumCert(cert.scheme, cert.committee,
                                               QuorumCert.make_bitmap(forged, cert.committee), agg).encode()
        short = cert.agg_sig[:128] if cert.scheme == "ed25519" else cert.agg_sig
        out["a short weight"].qc = QuorumCert(cert.scheme, cert.committee,
                                              QuorumCert.make_bitmap(idx[:2], cert.committee), short).encode()
    else:
        sigs = header.signature_list
        flip = bytearray(sigs[0].signature)
        flip[40] ^= 1
        out["a flipped signature"].signature_list = [SignatureTuple(sigs[0].index, bytes(flip))] + sigs[1:]
        out["a forged bitmap"].signature_list = [SignatureTuple(sigs[1].index, sigs[0].signature),
                                                 SignatureTuple(sigs[0].index, sigs[1].signature)] + sigs[2:]
        out["a short weight"].signature_list = sigs[:2]
    out["a wrong sealer list"].sealer_list = list(reversed(header.sealer_list))
    for h in out.values():
        h.clear_hash_cache()
    return out


def check_headers(suite, reps, what: str) -> list[str]:
    """BlockValidator.check_block on the card on every replica's stable
    header (accepted) and on the tampered variants of the first (each
    rejected); every record under the host oracle. Returns the records'
    kinds."""
    from fisco_bcos_tpu_torch.consensus import BlockValidator

    validator = BlockValidator(suite)
    nodes = reps[0].ledger.consensus_nodes()
    nodes = sorted((n for n in nodes if n.node_type == "consensus_sealer"), key=lambda n: n.node_id)
    kinds = []
    for r in reps:
        header = r.ledger.header_by_number(1)
        kinds.append(check_record(suite, header, nodes, what))
        if not validator.check_block(header, nodes):
            raise AssertionError(f"{what}: BlockValidator rejected a stable header")
    for how, bad in tampered(reps[0].ledger.header_by_number(1)).items():
        if validator.check_block(bad, nodes):
            raise AssertionError(f"{what}: BlockValidator accepted the header with {how}")
    return kinds


_ORACLE_ROOTS: dict = {}  # the host oracle's txs root of a block's hash order (every round seals one order)


def check_root(reps, batch: FloodBatch, what: str) -> None:
    """The block's txs root: the header's equals the host oracle's merkle
    root of the block's tx hashes, which are the batch's (the kernels'
    digests, a sample of them against the host oracle)."""
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256

    block = reps[0].ledger.block_by_number(1, with_txs=False)
    hashes = tuple(block.tx_metadata)
    if sorted(hashes) != sorted(batch.hashes):
        raise AssertionError(f"{what}: the block is not the batch's {BLOCK_TXS} transactions")
    for i in batch.rng.sample(range(BLOCK_TXS), min(64, BLOCK_TXS)):
        if keccak256(batch.payloads[i]) != batch.hashes[i]:
            raise AssertionError(f"{what}: tx hash {i} != host oracle")
    if hashes not in _ORACLE_ROOTS:
        _ORACLE_ROOTS[hashes] = oracle_merkle_root(hashes, "keccak256")
    if block.header.txs_root != _ORACLE_ROOTS[hashes]:
        raise AssertionError(f"{what}: txs root != host oracle's merkle root")


def histogram_totals() -> dict:
    """(sum, count) of each CONSENSUS_HISTOGRAMS family, its series added."""
    from fisco_bcos_tpu_torch.utils.metrics import REGISTRY

    out = {}
    for name in CONSENSUS_HISTOGRAMS:
        snap = REGISTRY.histogram(name).snapshot().values()
        out[name] = (sum(v[1] for v in snap), sum(v[2] for v in snap))
    return out


def host_profile_round(card: str, suite, batch: FloodBatch) -> None:
    """One Ed25519-QC round under cProfile (host time by function): where
    the round's host time goes."""
    import cProfile
    import pstats

    with qc_mode(dict(CONSENSUS_MODES[0][1])):
        _, reps = consensus_committee(suite, batch)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(stable_round, reps, "the host-profiled round")
        wall = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (calls, primitive, own s, cumulative s, callers)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:HOST_PROFILE_TOP]
    total = sum(v[2] for v in stats.values())
    log(f"[{card}] one consensus round (Ed25519 QC) under cProfile: {wall:.1f} ms wall, {total * 1e3:.1f} ms of "
        f"profiled host time; by own time: " + "; ".join(
            f"{Path(f).name}:{line} {name} {v[2] * 1e3:.1f} ms ({v[2] / total:.1%}, {v[0]} calls)"
            for (f, line, name), v in top))


def consensus_rounds(card: str, suite, batch: FloodBatch) -> dict:
    """Each QC mode: CONSENSUS_ROUNDS timed rounds, each on a fresh
    committee, the first counted (its kernels, no plain version); the
    headers under BlockValidator and the host oracle; one profiled Ed25519
    round."""
    out = {}
    for label, env in CONSENSUS_MODES:
        with qc_mode(env):
            committees = [consensus_committee(suite, batch) for _ in range(CONSENSUS_ROUNDS)]
            before = histogram_totals()
            first, launches = path_counted(lambda: stable_round(committees[0][1], label),
                                           CONSENSUS_KERNELS[label], f"the {label} round")
            timed = [first] + [stable_round(reps, label) for _, reps in committees[1:]]
            after = histogram_totals()
            kinds = check_headers(suite, committees[0][1], label)
            check_root(committees[0][1], batch, label)
        spans = {}
        for r in timed:
            for k, v in r["spans"].items():
                spans.setdefault(k, []).extend(v)
        out[label] = {"round_ms": statistics.median(r["round_ms"] for r in timed),
                      "seal_ms": statistics.median(r["seal_ms"] for r in timed)}
        each = ", ".join(f"{r['round_ms']:.1f}" for r in timed)
        log(f"[{card}] consensus, {label}: 4 replicas stable-committed one {BLOCK_TXS}-tx block (inline dispatch, "
            f"one host thread); submit_proposal to the stable commit on every replica, median of {len(timed)}: "
            f"{out[label]['round_ms']:.1f} ms (each {each}); the "
            f"leader's seal {out[label]['seal_ms']:.1f} ms; the counted round launched {show_launches(launches)}")
        log(f"[{card}] consensus, {label}: stages, ms, median over the replicas of the timed rounds (spans "
            f"{len(timed)} x replicas): " + "; ".join(
                f"{k} {statistics.median(spans[k]):.2f} (max {max(spans[k]):.2f}, n {len(spans[k])})"
                for k in CONSENSUS_SPANS if k in spans)
            + "; histograms, mean ms over the rounds (observations): " + "; ".join(
                f"{k[len('fisco_'):]} {(after[k][0] - before[k][0]) / n:.2f} ({n})"
                for k in CONSENSUS_HISTOGRAMS if (n := after[k][1] - before[k][1])))
        log(f"[{card}] consensus, {label}: every replica's header accepted by BlockValidator on the card, its "
            f"record under the host oracle ({', '.join(sorted(set(kinds)))}); {', '.join(TAMPERED)} rejected; "
            f"the txs root == the host oracle's")
    with qc_mode(dict(CONSENSUS_MODES[0][1])):
        _, reps = consensus_committee(suite, batch)
        events, wall = profiled_round(lambda: stable_round(reps, "the profiled round"))
    kernels = {}
    for e in events:
        if not is_copy(e):
            kernels[e.name] = kernels.get(e.name, 0) + 1
    busy = union_us(events) / 1e3
    out["profiled"] = {"busy_ms": busy, "wall_ms": wall, "kernels": kernels}
    if busy > 0:
        log(f"[{card}] one consensus round (Ed25519 QC, {BLOCK_TXS} txs, the leader's seal and submit_proposal "
            f"to the stable commit), profiled: device busy {busy:.3f} ms of {wall:.2f} ms wall (device idle share "
            f"{1 - busy / wall:.4f}); device kernels by name {json.dumps(kernels)}; "
            f"{sum(is_copy(e) for e in events)} copies")
    else:
        log(f"[{card}] one consensus round, device busy: not measured (no device events in the trace)")
    host_profile_round(card, suite, batch)
    return out


def profiled_round(fn) -> tuple[list, float]:
    """(device events, wall ms) of `fn()` under torch.profiler, once (the
    rounds before it warmed every path; a round needs a fresh committee)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"], wall_ms


@contextlib.contextmanager
def dropping(reps, drop):
    """Each replica's front discards a frame for which `drop(replica,
    decoded message)` is true, while open (its on_receive wrapped)."""
    from fisco_bcos_tpu_torch.consensus.messages import PBFTMessage

    for r in reps:
        receive = r.front.on_receive
        r.front.on_receive = (lambda module_id, src, payload, r=r, receive=receive:
                              None if drop(r, PBFTMessage.decode(payload)) else receive(module_id, src, payload))
    try:
        yield
    finally:
        for r in reps:
            del r.front.on_receive


def run_reproposal(card: str, device, suite, batch: FloodBatch) -> None:
    """A view change whose new leader re-proposes a prepared 10,240-tx
    block with its transactions (Ed25519 QC, queued delivery): the first
    proposal's PREPAREs reach the next view's leader alone and every COMMIT
    is dropped, so that leader alone has prepared it; all four replicas
    time out, the new leader re-proposes, and the three others check the
    full-tx proposal with batch_admit on the consensus lane (counted); then
    batch_admit of the block against admit_batch alone, in turns. One
    prepared replica keeps the block out of three of the four view-change
    packets, each hashed on the host wherever it is signed or checked."""
    import numpy as np

    from fisco_bcos_tpu_torch.consensus.messages import PacketType
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch
    from fisco_bcos_tpu_torch.device.plane import device_lane
    from fisco_bcos_tpu_torch.txpool.validator import batch_admit
    from fisco_bcos_tpu_torch.utils.metrics import REGISTRY

    with qc_mode(dict(CONSENSUS_MODES[0][1])):
        gw, reps = consensus_committee(suite, batch, auto=False)
        if not round_leader(reps).sealer.seal_and_submit():
            raise AssertionError("re-proposal: the first leader's proposal was refused")
        next_leader = round_leader(reps, 1, 1)
        with dropping(reps, lambda r, m: m.packet_type == PacketType.COMMIT
                      or (m.packet_type == PacketType.PREPARE and r is not next_leader)):
            gw.deliver_all()
        prepared = [r for r in reps if (c := r.engine._caches.get(1)) is not None and c.prepared]
        if prepared != [next_leader] or any(r.ledger.block_number() for r in reps):
            raise AssertionError(f"re-proposal: {len(prepared)} replicas prepared, heads "
                                 f"{[r.ledger.block_number() for r in reps]}")
        lanes = lambda: {k: v for k, v in REGISTRY.counters_matching("fisco_device_plane_requests_total").items()  # noqa: E731
                         if 'op="admission.' in k}
        before = lanes()
        t0 = time.perf_counter()

        def view_change():
            for r in reps:
                r.engine.on_timeout()
            gw.deliver_all()

        _, launches = path_counted(view_change, REPROPOSAL_KERNELS, "the view change and re-proposal")
        vc_ms = (time.perf_counter() - t0) * 1e3
        check_stable(reps, "re-proposal")
        after = lanes()
    routed = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    if not routed or any('lane="consensus"' not in k for k in routed):
        raise AssertionError(f"re-proposal: batch_admit did not ride the consensus lane: {routed}")
    check_root(reps, batch, "re-proposal")
    check_headers(suite, reps, "re-proposal")
    log(f"[{card}] consensus re-proposal: the next view's leader alone prepared block 1, every COMMIT dropped; "
        f"all four timed out into view {reps[0].engine.view}, the new leader re-proposed the {BLOCK_TXS}-tx block "
        f"with its transactions and all four stable-committed it ({vc_ms:.1f} ms, queued delivery, one host thread); "
        f"batch_admit requests {routed}; launched {show_launches(launches)}")
    sigs = np.frombuffer(b"".join(batch.sigs), dtype=np.uint8).reshape(-1, 65)

    def full():
        txs = batch.fresh()
        t0 = time.perf_counter()
        with device_lane("consensus"):
            ok = batch_admit(txs, suite)
        ms = (time.perf_counter() - t0) * 1e3
        if not ok.all():
            raise AssertionError("batch_admit rejected a lane of the re-proposed block")
        return ms

    def alone():
        t0 = time.perf_counter()
        admit_batch(batch.payloads, sigs, device=device)
        return (time.perf_counter() - t0) * 1e3

    full(), alone()
    turns = {"admit_batch alone": [], "batch_admit (consensus lane)": []}
    for _ in range(REPROPOSAL_TURNS):
        for who in ("admit_batch alone", "batch_admit (consensus lane)", "batch_admit (consensus lane)",
                    "admit_batch alone"):
            turns[who].append(alone() if who == "admit_batch alone" else full())
    log(f"[{card}] the re-proposal's batch_admit of {BLOCK_TXS} decoded txs and admit_batch alone, in turns (ms): "
        + "; ".join(f"{k} median {statistics.median(v):.3f} ({', '.join(f'{x:.2f}' for x in v)})"
                    for k, v in turns.items()))


def run_big_committee(card: str, suite) -> None:
    """QuorumCollector.admit and verify_header_cert at 64 members in each
    scheme, one member's vote signed over another message, against the host
    oracle: with Ed25519 the aggregate fails and each vote is checked alone
    (isolation) before the quorum re-seals; with BLS the member is demoted
    first (its vote checked alone, before the aggregate, as isolation would
    cost 64 host pairings); the struck member, the certificate and a
    certificate naming the bad member in a good one's place, each against
    the oracle. Then the QC check at 4 and 64 members through the plane and
    direct, in turns."""
    from fisco_bcos_tpu_torch.consensus import qc
    from fisco_bcos_tpu_torch.consensus.config import min_quorum
    from fisco_bcos_tpu_torch.consensus.messages import PacketType
    from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as ref_bls
    from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref_ed
    from fisco_bcos_tpu_torch.txpool.quota import get_quotas

    h = bytes(range(32))
    quotas = get_quotas()
    saved = quotas.strike_window_s, quotas.demote_s
    quotas.strike_window_s = quotas.demote_s = 3600.0  # no strike ages out, no demotion lapses, mid-check
    for name in ("ed25519", "bls"):
        scheme = qc.get_scheme(name)
        ref_ok = ((lambda pub, m, s: ref_ed.verify(pub, m, s)) if name == "ed25519"
                  else (lambda pub, m, s: ref_bls.verify(pub, m, s)))
        times = {}
        for n in (4, BIG_COMMITTEE):
            t0 = time.perf_counter()
            kps = [scheme.derive_keypair(0xB16C0 + 131 * n + i) for i in range(n)]
            pubs = [kp.pub for kp in kps]
            msg32 = qc.vote_preimage(suite, PacketType.PREPARE, 0, 1, h)
            other = qc.vote_preimage(suite, PacketType.PREPARE, 0, 1, h[::-1])
            bad = BIG_BAD if n == BIG_COMMITTEE else None
            votes = {i: scheme.sign_vote(kp, other if i == bad else msg32) for i, kp in enumerate(kps)}
            setup_s = time.perf_counter() - t0
            if bad is None:
                cert = scheme.build_cert({i: votes[i] for i in range(n - 1)}, n)
            else:
                get_quotas().reset()
                col = qc.QuorumCollector(suite, scheme)
                key = (int(PacketType.PREPARE), 1, 0, h)
                for i, s in votes.items():
                    col.add_vote(key, i, s)
                if name == "bls":
                    for _ in range(3):
                        get_quotas().note_invalid(qc.STRIKE_GROUP, col._strike_source(pubs[bad]), 1)
                t0 = time.perf_counter()
                valid, struck, cert = col.admit(key, msg32, None, pubs, lambda i: 1, min_quorum(n),
                                                authenticated_fn=lambda i: True)
                admit_ms = (time.perf_counter() - t0) * 1e3
                strikes = {s: len(d) for s, d in get_quotas()._groups[qc.STRIKE_GROUP].strikes.items()}
                want_bad = {i for i in ((bad, 0, n - 1) if name == "bls" else range(n))
                            if not ref_ok(pubs[i], msg32, votes[i])}
                if struck != want_bad or valid != set(range(n)) - want_bad or cert is None:
                    raise AssertionError(f"{name} at {n}: struck {struck}, oracle {want_bad}")
                if strikes.get(col._strike_source(pubs[bad])) != (4 if name == "bls" else 1):
                    raise AssertionError(f"{name} at {n}: the bad member's strikes {strikes}")
                log(f"[{card}] QuorumCollector.admit, {name} at {n} members, member {bad}'s vote bad: struck "
                    f"{sorted(struck)} == the host oracle, {len(valid)} admitted, certificate of "
                    f"{len(cert.encode())} bytes; {admit_ms:.1f} ms ({col.stats()['fallbacks']} aggregate "
                    f"fallbacks; keys and votes made in {setup_s:.1f} s on the host)")
            swap = cert.signers()
            absent = next(i for i in range(n) if i not in swap)
            wrong = qc.QuorumCert(cert.scheme, n, qc.QuorumCert.make_bitmap(swap[1:] + [absent], n), cert.agg_sig)
            if name == "ed25519":  # the signatures in bitmap order, the absent member's last
                oracle = [all(ref_ed.verify(pubs[i], msg32, c.agg_sig[64 * k:64 * k + 64])
                              for k, i in enumerate(c.signers())) for c in (cert, wrong)]
            else:
                oracle = [ref_bls.aggregate_verify([pubs[i] for i in c.signers()], msg32, c.agg_sig)
                          for c in (cert, wrong)]
            got = [qc.verify_header_cert(c, pubs, msg32) for c in (cert, wrong)]
            if got != oracle or got != [True, False]:
                raise AssertionError(f"{name} at {n}: verify_header_cert {got}, oracle {oracle}")

            def check(plane: bool) -> float:
                if plane:
                    os.environ.pop("FISCO_DEVICE_PLANE", None)
                else:
                    os.environ["FISCO_DEVICE_PLANE"] = "0"
                t0 = time.perf_counter()
                ok = scheme.verify_cert(cert, pubs, msg32)
                ms = (time.perf_counter() - t0) * 1e3
                if not ok:
                    raise AssertionError(f"{name} at {n}: a good certificate failed")
                return ms

            check(True), check(False)
            turns = {"plane": [], "direct": []}
            try:
                for _ in range(QC_TURNS):
                    for plane in (True, False, False, True):
                        turns["plane" if plane else "direct"].append(check(plane))
            finally:
                os.environ.pop("FISCO_DEVICE_PLANE", None)
            times[n] = turns
        log(f"[{card}] QC check (verify_cert of a quorum's certificate), {name}, in turns (ms): " + "; ".join(
            f"{n} members {k} median {statistics.median(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
            for n, turns in times.items() for k, v in turns.items()))
    get_quotas().reset()
    quotas.strike_window_s, quotas.demote_s = saved
    crypto = qc.get_scheme("bls")._impl
    kp = crypto.generate_keypair(secret=0xB1)
    sig = crypto.sign(kp, h)
    t0 = time.perf_counter()
    crypto.verify(kp.pub, h, sig)
    log(f"[{card}] one BLS vote checked alone (verify_one: a host pairing, what isolation pays a member): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


def run_consensus_phase(card: str, device) -> dict:
    """PBFT consensus on the card (``fisco_bcos_tpu_torch/consensus``):
    BASELINE config 4's committee of four replicas, each with its own
    Ledger, TxPool, PBFTEngine, Sealer and ConsensusStorage over one
    InprocGateway, agrees on a 10,240-tx flood block in each QC mode
    (Ed25519, BLS, FISCO_QC=0), execution ended at this script's stand-in;
    a view change re-proposes a prepared 10,240-tx block with its
    transactions (batch_admit on the consensus lane); BlockValidator on
    every stable header and its tampered variants; the collector and the
    certificate check at 64 members. Every root, record and verdict against
    the host oracle."""
    from fisco_bcos_tpu_torch.crypto.suite import ecdsa_suite

    t0 = time.perf_counter()
    suite = ecdsa_suite(device)
    signers = flood_signers("ecdsa")
    batch = FloodBatch("ecdsa", CONSENSUS_BATCH, device, signers)
    batch.check_signatures(signers)
    log(f"[{card}] consensus phase: {BLOCK_TXS} transactions built and signed in {time.perf_counter() - t0:.1f} s")
    rounds = consensus_rounds(card, suite, batch)
    run_big_committee(card, suite)
    run_reproposal(card, device, suite, batch)
    log(f"[{card}] consensus phase: {time.perf_counter() - t0:.1f} s")
    return rounds


def phase_clock():
    """lap(name) logs the seconds since the last lap (or since this call)
    and since this call: the command time a phase takes."""
    start = last = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log(f"[phase] {name}: {now - last:.1f} s (command so far {now - start:.1f} s)")
        last = now

    return lap


ROW_KEYS = (
    "name", "route", "source", "replaces", "launches", "max_abs_err",
    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
)


def log_kernel(card: str, row: dict) -> None:
    if "device_ms" in row:
        log(f"[{card}] {row['name']} @ {BLOCK_TXS} lanes: the kernel alone, median over a profiled "
            f"run of 20 calls: {show_device_ms(row['device_ms'])}")
    log(f"[{card}] {row['name']} @ {row.get('lanes', BLOCK_TXS)} lanes: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.1f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, {row['ops']} {row['ops_kind']}), "
        f"{row['launches']} launch(es) on its path")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="another checkout whose kernels each kernel is timed against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch, admit_batch_sm
    from fisco_bcos_tpu_torch.device import resolve_device
    from fisco_bcos_tpu_torch.ops import _kernels

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    lap = phase_clock()
    t0 = time.perf_counter()
    names = list(_kernels.SOURCES)
    parent = load_kernels_module(args.parent) if args.parent else None
    checkouts = {"this": Path(__file__).resolve().parent}
    if args.parent:
        checkouts["parent"] = Path(args.parent)
    builds = [lambda n=n: _kernels.build(n) for n in names]
    builds += [lambda n=n: parent.build(n) for n in names if n in parent.SOURCES] if parent else []
    builds += [lambda c=c: build_field_bench(c) for c in checkouts.values()]
    builds += [lambda n=n: build_stage_variant(n) for n in STAGE_SIZES]
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source, all started together
        results = list(pool.map(lambda f: f(), builds))
    built = dict(zip(names, results))  # this checkout's kernels
    stage_libs = dict(zip(STAGE_SIZES, results[-len(STAGE_SIZES):]))
    bench_libs = dict(zip(checkouts, results[-len(checkouts) - len(STAGE_SIZES):-len(STAGE_SIZES)]))
    log(f"build: {json.dumps({k: round(v['seconds'], 3) for k, v in built.items()})} "
        f"({time.perf_counter() - t0:.3f} s, field bench{' and parent checkout' if parent else ''} too)")
    for name, b in built.items():  # ptxas -v: registers, stack and spills; size; launch geometry
        for line in (ln.strip() for ln in b["log"].splitlines()):
            if ("Used" in line or "Compiling entry function" in line
                    or ("spill" in line and not line.startswith("0 bytes stack frame"))):
                log(f"  {name}: {line}")
        sizes = sass_by_function(_kernels.library_path(name))
        size = sum(sizes.values())
        log(f"  {name}: " + (f"{size} SASS instructions ({size * 16 / 1024:.0f} KiB)" if size else
                             "SASS size not measured (no cuobjdump)")
            + f"; launch geometry of the first kernel at {BLOCK_TXS} lanes "
            + json.dumps(_kernels.geometry(name, BLOCK_TXS)))
        if len(sizes) > 1:
            log(f"  {name}: SASS instructions a kernel {json.dumps(sizes)}")

    lap('builds')
    # -- the device observatory, in fresh interpreters over the libraries just built --
    run_observatory_phase(card)

    lap('observatory')
    device = resolve_device()
    t0 = time.perf_counter()
    cases = make_cases(UNIQUE_SIGNERS, SEED)
    block = make_bench_block(BENCH_SIGNERS)
    verify_cases = make_verify_cases(UNIQUE_SIGNERS, SEED + 1)
    verify_block = verify_rows_from_block(block)
    sm_cases = make_sm2_cases(UNIQUE_SIGNERS, SEED + 3)
    sm_block = make_sm2_bench_block(BENCH_SIGNERS)
    log(f"secp256k1: {len(cases)} mixed recover cases, {len(verify_cases)} mixed verify cases, "
        f"{len(block)} valid signers; SM2: {len(sm_cases)} mixed cases, {len(sm_block)} valid "
        f"signers; built on the host in {time.perf_counter() - t0:.1f} s")

    # -- secp256k1 admission (recover kernel) --
    mixed_err = check_mixed_block(cases, device)
    launches, admit_ms = run_main_path(block, device)
    recover = measure_recover_kernel(block, device)
    recover["launches"] = launches["secp256k1_recover"]
    recover["max_abs_err"] = max(recover["max_abs_err"], mixed_err)
    log_kernel(card, recover)
    log(f"[{card}] admit_batch @ {BLOCK_TXS} txs: {admit_ms:.2f} ms end to end "
        f"({BLOCK_TXS / admit_ms * 1e3:.0f} tx/s)")
    # with --parent, the stages as the parent composes them too, in turns parent, new, new, parent
    turns = (parent, None, None, parent) if parent else (None,)
    for who in turns:
        stages = admission_stages(block, device, who)
        log(f"[{card}] admit_batch stages{' (parent checkout)' if who else ''} (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    log_busy(card, "admit_batch", lambda: admit_batch(payloads, sigs65))

    lap('secp256k1 admission')
    # -- secp256k1 verify --
    verify_mixed_err, _ = check_verify_block(verify_cases, device, "verify mixed block")
    verify_err, verify_plain_ms = check_verify_block(verify_block, device, "verify timed block")
    verify_launches, verify_batch_ms = run_verify_path(verify_block)
    verify = measure_verify_kernel(verify_block, device)
    verify.update(
        launches=verify_launches, max_abs_err=max(verify_err, verify_mixed_err), plain_ms=verify_plain_ms
    )
    log_kernel(card, verify)
    adds4, adds5 = warp_additions(verify_block)
    log(f"verify ladder additions a warp on the timed block (host count): 4-bit windows "
        f"{adds4:.2f}, signed 5-bit windows {adds5:.2f}")
    log(f"[{card}] secp256k1 verify_batch @ {BLOCK_TXS} signatures: {verify_batch_ms:.2f} ms "
        f"end to end ({BLOCK_TXS / verify_batch_ms * 1e3:.0f} verifies/s)")
    for who in turns:
        v_stages = verify_stages(verify_block, device, who)
        log(f"[{card}] verify_batch stages{' (parent checkout)' if who else ''} (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in v_stages.items()))

    lap('secp256k1 verify')
    # -- SM2 / SM-suite admission --
    sm_mixed_err, sm_plain_ms = check_sm2_mixed_block(sm_cases, device)
    sm_launches, sm_admit_ms = run_sm_path(sm_block)
    sm2_row, sm2_verify_batch_ms = measure_sm2(sm_block, device, sm_plain_ms, sm_mixed_err)
    sm2_row["launches"] = sm_launches["sm2_verify"]
    log_kernel(card, sm2_row)
    log(f"[{card}] sm2.verify_batch @ {BLOCK_TXS} signatures: {sm2_verify_batch_ms:.2f} ms "
        f"end to end ({BLOCK_TXS / sm2_verify_batch_ms * 1e3:.0f} verifies/s)")
    log(f"[{card}] admit_batch_sm @ {BLOCK_TXS} txs: {sm_admit_ms:.2f} ms end to end "
        f"({BLOCK_TXS / sm_admit_ms * 1e3:.0f} tx/s)")
    for who in turns:
        sm_stages = sm_admission_stages(sm_block, device, who)
        log(f"[{card}] admit_batch_sm stages{' (parent checkout)' if who else ''} (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in sm_stages.items()))
    sm_payloads, sigs128, _ = sm2_tile(sm_block, BLOCK_TXS)
    log_busy(card, "admit_batch_sm", lambda: admit_batch_sm(sm_payloads, sigs128))

    lap('SM admission')
    # -- hash kernels: the packed forms, the forms, the merkle root --
    hash_errs = check_hash_kernels(device)
    hash_errs.update(check_hash_forms(cases, sm_cases, device))
    merkle_launches, merkle_trees = check_merkle(card, device)
    hash_rows = []
    for name, path_payloads, path_launches in (
        ("keccak256", payloads, merkle_launches), ("sm3", sm_payloads, sm_launches)
    ):
        row = measure_hash_kernel(name, path_payloads, device)
        row.update(launches=path_launches[row["name"]],
                   max_abs_err=max(row["max_abs_err"], hash_errs[row["name"]]))
        log_kernel(card, row)
        hash_rows.append(row)
    sha_row = measure_sha256(card, device, merkle_launches["sha256_packed"])
    sha_row["max_abs_err"] = max(sha_row["max_abs_err"], hash_errs["sha256_packed"])
    log_kernel(card, sha_row)
    hash_rows.append(sha_row)
    forms = form_inputs(block, sm_block, device)
    path_launches = {k: v for counts in (launches, sm_launches) for k, v in counts.items() if v}
    for row in measure_hash_forms(forms, path_launches):
        row["max_abs_err"] = max(row["max_abs_err"], hash_errs[row["name"]])
        log_kernel(card, row)
        hash_rows.append(row)

    lap('hash kernels')
    # -- the CryptoSuite seam, driven as the node drives it --
    run_suite_phase(card, block, cases, sm_block, sm_cases, verify_cases, merkle_trees)

    lap('suite')
    # -- Ed25519: the kernel, verify_batch, the suite's Ed25519Crypto --
    ed_rows, ed_block, ed_cases = run_ed25519_phase(card, device, parent)

    lap('Ed25519')
    # -- Poseidon: the kernel, the state plane's commitment at its defaults --
    poseidon_row_, poseidon_blocks = run_poseidon_phase(card, device)
    log_kernel(card, poseidon_row_)

    lap('Poseidon')
    # -- BLS12-381: the pairing kernel, BLSCrypto's aggregate (QC) check --
    bls_row = run_bls_phase(card, device, parent)
    log_kernel(card, bls_row)

    lap('BLS')
    # -- BLS12-381: the multi-pairing kernel, header sync's multi_pairing_verify --
    multi_row = run_multi_pairing_phase(card, device, parent)
    log_kernel(card, multi_row)

    lap('multi-pairing')
    # -- the DevicePlane: every seam merged, the window, concurrent callers, lanes --
    run_plane_phase(card, device, cases, verify_cases, sm_cases, ed_cases, block, verify_block, sm_block, ed_block)

    lap('plane')
    # -- the multi-device fan-out: every sharded program on one card and on logical meshes over it --
    run_sharding_phase(card, device, cases, verify_cases, sm_cases, ed_cases, block)

    lap('sharding')
    # -- the node's transaction pool: the flood admitted, sealed and written; an SM batch --
    run_txpool_phase(card, device)

    lap('txpool')
    # -- PBFT consensus: four replicas agree on a 10,240-tx block in each QC mode; a re-proposal; 64 members --
    run_consensus_phase(card, device)

    lap('consensus')
    timed_args = timed_kernel_args(device, block, verify_block, sm_block, forms, ed_block, poseidon_blocks)
    if parent:
        time_against_parent(card, parent, timed_args,
                            parent_kernel_args(parent, device, verify_block, args.parent, timed_args))
    lane_scaling(card, timed_args)
    lap('parent and lane scaling')
    call_anatomy(card, timed_args["keccak256_packed"], timed_args["ed25519_challenge"], parent)
    lap('call anatomy')
    stage_sweep(card, {**stage_libs, 16384: _kernels.library_path("keccak256")}, device)
    lap('stage sweep')
    field_bench(card, bench_libs, {label: checkout_poseidon_table(c, device) for label, c in checkouts.items()})
    lap('field bench')
    hash_bench(card, bench_libs)
    lap('hash bench')
    bench = bls_bench(card, bench_libs)
    bls_latency_floor(card, bench, bls_row["one_lane_ms"], bls_row["one_lane_bound_ms"])
    bls_multi_latency_floor(card, bench, multi_row["times"])

    lap('BLS bench and floors')
    drain_plane()  # every request of every phase answered: a failed one has raised
    rows = (recover, verify, sm2_row, *hash_rows, *ed_rows, poseidon_row_, bls_row, multi_row)
    log(json.dumps({"kernels": [{k: row[k] for k in ROW_KEYS} for row in rows]}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
