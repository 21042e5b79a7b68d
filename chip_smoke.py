#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repo's ``fisco_bcos_tpu_torch`` package;
exits non-zero, printing no result, without them. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the path from ``fisco_bcos_tpu_torch/csrc`` (timed);
3. on a 10,240-lane block with invalid lanes mixed in, holds the
   secp256k1 recover kernel against its plain PyTorch version on the card,
   bit for bit, one lane of every distinct case against the host oracle,
   and ``admit_batch``'s four outputs against the host oracle (reference
   keccak and reference ECDSA);
4. runs ``admit_batch`` — the main path — on a 10,240-transaction block of
   valid transactions built as ``bench.py``'s admission benchmark builds
   them, on the default device, with every kernel launch counter set to 0
   just before and read just after, and holds its outputs against the host
   oracle;
5. on that block, times the kernel, its plain version, ``admit_batch`` and
   each of its stages (CUDA events / synchronised host clock, medians of
   warm runs) and the card's busy time in one profiled call, and prints
   them beside the card's name and power limit, one JSON line describing
   every kernel, and last the JSON result line.

No phase's failure is caught: any mismatch or error ends the script with a
traceback and a non-zero exit code.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

BLOCK_TXS = 10_240  # a 10k-tx block, bucketed as hash_common._bucket does
UNIQUE_SIGNERS = 128  # distinct cases of the mixed (correctness) block
BENCH_SIGNERS = 64  # distinct signers of the timed block, as in bench.py
SEED = 20_261_016

# H100 SXM: 32-bit integer multiply(-add) issues at 64 per clock per SM,
# half the fp32 FMA rate; the fp32 peak is 67 TFLOP/s counting an FMA as 2
# operations, so 67e12 / 2 / 2 integer multiplies per second.
INT32_MUL_PER_S = 67e12 / 4
HBM_BYTES_PER_S = 3.35e12

# 32-bit multiplies of the least work per operation of the kernel
# (csrc/secp256k1_recover.cu), each 32x32->64 product counted as two (low
# and high half): a 256-bit squaring needs 36 word products, not 64, and a
# product by a word that is 0 or 1 by construction is no work.
MULS_FP_MUL = 2 * (64 + 8 + 1)  # 8x8 words, fp_reduce_wide, fp_fold_top
MULS_FP_SQR = 2 * (36 + 8 + 1)
MULS_FP_SMALL = 2 * (8 + 1)  # fp_mul_small + fp_fold_top
MULS_FN_MUL = 2 * (64 + 32 + 20 + 4)  # 8x8 words + three folds by CN (CN[4] = 1)
MULS_FN_SQR = 2 * (36 + 32 + 20 + 4)
MULS_GLV = 2 * (2 * 80 + 4 * 16)  # two u2·g products; four c·basis, 4x4 words each


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
# Operation count of the recover kernel for this run's inputs
# ---------------------------------------------------------------------------


def _pow_ops(e: int) -> tuple[int, int]:
    """(multiplications, squarings) of the kernel's f_pow for exponent e:
    a 14-product table, then 4 squarings and a product per 4-bit window
    after the first nonzero one."""
    wins = [(e >> (4 * i)) & 0xF for i in range(63, -1, -1)]
    first = next(i for i, c in enumerate(wins) if c)
    rest = wins[first + 1 :]
    return 14 + sum(1 for c in rest if c), 4 * len(rest)


def recover_multiplies(case_hash: bytes, sig65: bytes) -> int:
    """32-bit multiplies of the least work the recover kernel's method needs
    for one lane, following its control flow: early exit on invalid input
    or a non-residue, then 33 windows of 4 doublings plus an addition per
    nonzero window. Doublings of the still-identity accumulator and the
    first addition to it are no work and are not counted."""
    from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
    from fisco_bcos_tpu_torch.ops.ec import glv_params

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
    P = glv_params()
    c1 = (u2 * P.g1) >> 448
    c2 = (u2 * P.g2) >> 448
    ka = abs(u2 - (c1 * P.a1 + c2 * P.a2))
    kb = abs(c1 * P.b1_abs - c2 * P.b2)
    lo, hi = u1 & ((1 << 128) - 1), u1 >> 128
    # the c·R table: 14 additions of R, whose Z is 1 (so each is a mixed
    # addition, 11 products), and its β view (15 products)
    fp_mul += 14 * 11 + 15
    small = 14 * 2
    started = False
    for i in range(32, -1, -1):
        if started:
            fp_mul, fp_sqr, small = fp_mul + 4 * 6, fp_sqr + 4 * 2, small + 4
        for k, mul in ((ka, 12), (kb, 12), (lo, 11), (hi, 11)):
            if (k >> (4 * i)) & 0xF:
                if started:
                    fp_mul, small = fp_mul + mul, small + 2
                started = True
    expected = ref.ecdsa_recover(case_hash, r, s, v)
    if expected is not None:
        inv_m, inv_s = _pow_ops(C.p - 2)
        fp_mul, fp_sqr = fp_mul + inv_m + 2, fp_sqr + inv_s
    return (
        fp_mul * MULS_FP_MUL + fp_sqr * MULS_FP_SQR + small * MULS_FP_SMALL
        + fn_mul * MULS_FN_MUL + fn_sqr * MULS_FN_SQR + MULS_GLV
    )


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


def kernel_vs_plain(z, r, s, v, what: str):
    """Kernel and plain version on the same card tensors, bit for bit.
    Returns the kernel's outputs and the largest elementwise difference."""
    import torch

    from fisco_bcos_tpu_torch.ops import secp256k1

    kernel = secp256k1.recover_device(z, r, s, v)
    plain = secp256k1.recover_plain(z, r, s, v)
    torch.cuda.synchronize()
    for name, a, b in zip(("qx", "qy", "ok"), kernel, plain):
        if not torch.equal(a, b):
            bad = (a != b).reshape(len(z), -1).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"recover kernel != plain on {name} of the {what}, lanes {bad}")
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(kernel, plain))
    return kernel, err


def check_outputs(got, want, what: str) -> None:
    import numpy as np

    for name, g, w in zip(("senders", "ok", "pubkeys", "tx hashes"), got, want):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"admit_batch {name} != host oracle on the {what}")


def check_mixed_block(cases, device) -> int:
    """The block with invalid lanes: kernel == plain on every lane, one lane
    of every distinct case == host oracle, admit_batch == host oracle.
    Returns the kernel's largest difference from the plain version."""
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch
    from fisco_bcos_tpu_torch.ops.bigint import limbs_to_int

    payloads, sigs65, picked = tile(cases, BLOCK_TXS)
    kernel, err = kernel_vs_plain(*recover_inputs(payloads, sigs65, device), "mixed block")
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


def run_main_path(block, device) -> tuple[dict, float]:
    """The main path: admit_batch on the 10,240-tx block on the default
    device, launch counters zeroed just before and read just after, its
    outputs held against the host oracle. Returns the launch counts and the
    median end-to-end ms of warm calls."""
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch
    from fisco_bcos_tpu_torch.ops import _kernels

    payloads, sigs65, picked = tile(block, BLOCK_TXS)
    _kernels.reset_launches()
    out = admit_batch(payloads, sigs65)
    launches = dict(_kernels.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    check_outputs(out, expected_admission(picked), "main path's block")
    log(f"main path: admit_batch on {BLOCK_TXS} txs == host oracle ({int(out[1].sum())} ok); "
        f"launches {launches}")
    return launches, host_ms(lambda: admit_batch(payloads, sigs65), reps=5)


def measure_recover_kernel(block, device) -> dict:
    """The kernel on the main path's inputs: equal to the plain version,
    both timed, and the bound from these inputs' work."""
    from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
    from fisco_bcos_tpu_torch.ops import secp256k1

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    z, r, s, v = recover_inputs(payloads, sigs65, device)
    _, err = kernel_vs_plain(z, r, s, v, "main path's block")
    kernel_ms = cuda_ms(lambda: secp256k1.recover_device(z, r, s, v))
    plain_ms = host_ms(lambda: secp256k1.recover_plain(z, r, s, v), reps=3)

    per_case = [recover_multiplies(keccak256(c[0]), c[1]) for c in block]
    muls = sum(per_case[i % len(block)] for i in range(BLOCK_TXS))
    ops_ms = muls / INT32_MUL_PER_S * 1e3
    io_bytes = BLOCK_TXS * (3 * 16 * 4 + 4) + 60 * 8 * 4 + BLOCK_TXS * (2 * 16 * 4 + 1)
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "secp256k1_recover",
        "route": "cuda",
        "source": "fisco_bcos_tpu_torch/csrc/secp256k1_recover.cu",
        "replaces": "fisco_bcos_tpu/ops/pallas_ec.py:63",
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,  # no single PyTorch call computes ECDSA recovery
        "int32_multiplies": muls,
    }


def admission_stages(block, device) -> dict[str, float]:
    """Median ms of each stage of admit_batch on the block, each stage run
    warm and ending synchronised (the stages of admission_core, in order)."""
    import torch

    from fisco_bcos_tpu_torch.crypto import admission
    from fisco_bcos_tpu_torch.ops import keccak, secp256k1
    from fisco_bcos_tpu_torch.ops.address import sender_address_device
    from fisco_bcos_tpu_torch.ops.bigint import digest_words_le_to_limbs

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    st: dict = {}

    def host_pad():
        st["host"] = admission.host_inputs(payloads, sigs65)

    def upload():
        st["dev"] = [torch.from_numpy(a).to(device) for a in st["host"]]

    def tx_hash():
        blocks, nblocks = st["dev"][:2]
        st["z"] = digest_words_le_to_limbs(keccak.keccak256_blocks(blocks, nblocks))

    def recover():
        st["q"] = secp256k1.recover_device(st["z"], *st["dev"][2:])

    def address():
        st["addr"] = sender_address_device(st["q"][0], st["q"][1])

    def pack_download():
        qx, qy, ok = st["q"]
        admission.pack_admission_device(st["addr"], ok, qx, qy, st["z"]).cpu()

    stages = (host_pad, upload, tx_hash, recover, address, pack_download)
    return {fn.__name__: host_ms(fn, reps=3) for fn in stages}


def device_busy_ms(fn) -> tuple[float, float]:
    """(busy, wall) ms of one warm call of `fn` under torch.profiler: busy
    is the union of the device-side event intervals of the trace (0.0 when
    the profiler records no device events), wall the host clock around the
    same call, profiler overhead included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        # the profiler's own buffer bookkeeping is not the program's work
        if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"
    )
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us / 1e3, wall_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    from fisco_bcos_tpu_torch.device import resolve_device
    from fisco_bcos_tpu_torch.ops import _kernels

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = {name: _kernels.build(name) for name in _kernels.SOURCES}
    log(f"build: {json.dumps({k: round(v['seconds'], 3) for k, v in built.items()})} "
        f"({time.perf_counter() - t0:.3f} s)")
    for name, b in built.items():  # ptxas -v: registers, stack and spills
        for line in (ln.strip() for ln in b["log"].splitlines()):
            if "Used" in line or ("spill" in line and not line.startswith("0 bytes stack frame")):
                log(f"  {name}: {line}")

    device = resolve_device()
    t0 = time.perf_counter()
    cases = make_cases(UNIQUE_SIGNERS, SEED)
    block = make_bench_block(BENCH_SIGNERS)
    log(f"{len(cases)} mixed cases and {len(block)} valid signers built on the host "
        f"in {time.perf_counter() - t0:.1f} s")

    mixed_err = check_mixed_block(cases, device)
    launches, admit_ms = run_main_path(block, device)
    recover = measure_recover_kernel(block, device)
    recover["launches"] = launches["secp256k1_recover"]
    recover["max_abs_err"] = max(recover["max_abs_err"], mixed_err)

    log(f"[{card}] secp256k1_recover @ {BLOCK_TXS} lanes: kernel {recover['ms']:.4f} ms, "
        f"plain {recover['plain_ms']:.1f} ms, bound {recover['bound_ms']:.4f} ms "
        f"({recover['bound_by']}, {recover['int32_multiplies']} int32 multiplies)")
    log(f"[{card}] admit_batch @ {BLOCK_TXS} txs: {admit_ms:.2f} ms end to end "
        f"({BLOCK_TXS / admit_ms * 1e3:.0f} tx/s)")
    stages = admission_stages(block, device)
    log(f"[{card}] admit_batch stages (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    from fisco_bcos_tpu_torch.crypto.admission import admit_batch

    payloads, sigs65, _ = tile(block, BLOCK_TXS)
    busy, wall = device_busy_ms(lambda: admit_batch(payloads, sigs65))
    if busy > 0:
        log(f"[{card}] admit_batch, one profiled call: device busy {busy:.3f} ms of "
            f"{wall:.2f} ms wall (device idle share {1 - busy / wall:.3f})")
    else:
        log(f"[{card}] admit_batch device busy: not measured (no device events in the trace)")
    row = {k: recover[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
    )}
    log(json.dumps({"kernels": [row]}))
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
