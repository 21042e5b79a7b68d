"""The port's DevicePlane (``fisco_bcos_tpu_torch/device/plane.py``) on the
CPU: its scheduler with fake executors (the cases of
tests/test_device_plane.py on the JAX plane: coalescing to high water,
window expiry, lanes and starvation, an executor's exception reaching every
future, concurrent submitters, group-fair selection), each pick held
against the JAX plane's on the same submissions, then every seam kind
routed through it with ``device="cpu"``: concurrent callers merged into one
dispatch, each caller's slice equal to its own direct call
(``FISCO_DEVICE_PLANE=0``) and to the oracles. No JAX program is traced."""

from __future__ import annotations

import hashlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto import admission, suite
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref_ed25519
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.device.plane import DevicePlane, device_group, device_lane
from fisco_bcos_tpu_torch.ops import _kernels, merkle
from fisco_bcos_tpu_torch.ops import secp256k1 as secp_ops

ORACLES = {"keccak256": keccak256, "sm3": sm3, "sha256": lambda m: hashlib.sha256(m).digest()}
RAGGED = (1, 4, 7, 100, 1000)  # callers' batch sizes, merged into one dispatch


@pytest.fixture
def install(monkeypatch):
    """A fresh plane as the process-wide one; no kernel may load."""
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))

    def make(**kw) -> DevicePlane:
        plane = DevicePlane(**kw)
        monkeypatch.setattr(plane_mod, "_PLANE", plane)
        return plane

    return make


def _echo_exec(calls):
    def run(reqs):
        calls.append([r.n for r in reqs])
        return [r.payload for r in reqs]

    return run


def _noop_exec(reqs):
    return [None] * len(reqs)


def _concurrently(calls):
    """Run each zero-argument call on a thread of its own, all released
    together; returns their results in order (re-raising the first
    failure)."""
    barrier = threading.Barrier(len(calls))
    out: list = [None] * len(calls)

    def worker(i):
        barrier.wait()
        try:
            out[i] = ("ok", calls[i]())
        except BaseException as e:  # noqa: BLE001 - handed to the test thread
            out[i] = ("err", e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a caller did not finish within 300 s"
    for kind, value in out:
        if kind == "err":
            raise value
    return [value for _, value in out]


def _merging(install, sizes):
    """A plane that dispatches once every one of `sizes`' requests is queued
    (high water at their sum, a window no test waits out)."""
    return install(window_ms=60_000, high_water=sum(sizes), starvation_ms=60_000)


# -- the scheduler, with fake executors --------------------------------------


def test_coalescer_merges_up_to_high_water():
    plane = DevicePlane(window_ms=60_000, high_water=8, starvation_ms=60_000)
    calls: list[list[int]] = []
    f1 = plane.submit("echo", ["a", "b", "c"], 3, _echo_exec(calls))
    f2 = plane.submit("echo", ["d", "e"], 2, _echo_exec(calls))
    f3 = plane.submit("echo", ["f", "g", "h"], 3, _echo_exec(calls))  # total 8
    assert f1.result(timeout=10) == ["a", "b", "c"]
    assert f2.result(timeout=10) == ["d", "e"]
    assert f3.result(timeout=10) == ["f", "g", "h"]
    assert calls == [[3, 2, 3]]
    assert plane.coalesce_ratio() == 3.0
    assert plane.stats() == {"requests": 3, "dispatches": 1, "merged_requests": 3, "items": 8, "queue_depth": 0}
    assert plane.drain(timeout=10) and plane.wait_p99_ms() >= 0.0


def test_window_expiry_dispatches_partial_batch():
    plane = DevicePlane(window_ms=10, high_water=1 << 30, starvation_ms=60_000)
    calls: list[list[int]] = []
    assert plane.submit("echo", ["x"], 1, _echo_exec(calls)).result(timeout=10) == ["x"]
    assert calls == [[1]]


def test_priority_lanes_and_starvation_ordering():
    plane = DevicePlane(window_ms=0, autostart=False)
    with device_lane("sync"):
        plane.submit("op.sync", ["s"], 1, _noop_exec)
    time.sleep(0.002)
    with device_lane("consensus"):
        plane.submit("op.cons", ["c"], 1, _noop_exec)
    plane.submit("op.adm", ["a"], 1, _noop_exec)  # the default lane
    assert plane.lane_depths() == {"consensus": 1, "admission": 1, "sync": 1, "proof": 0}

    now = time.perf_counter()
    plane.starvation_ms = 60_000  # nothing starved: lane order decides
    op, reqs, _ = plane._pick_ready_locked(now)
    assert op == "op.cons" and reqs[0].lane == "consensus"
    plane._pending[op] = reqs

    plane.starvation_ms = 0.001  # everything starved: the oldest first
    op, _, _ = plane._pick_ready_locked(now)
    assert op == "op.sync"


def test_executor_exception_propagates_to_all_futures():
    plane = DevicePlane(window_ms=60_000, high_water=2, starvation_ms=60_000)

    def boom(reqs):
        raise ValueError("device fell over")

    f1 = plane.submit("boom", [1], 1, boom)
    f2 = plane.submit("boom", [2], 1, boom)  # crosses high water
    for f in (f1, f2):
        with pytest.raises(ValueError, match="fell over"):
            f.result(timeout=10)
    # the worker survives a failed dispatch; an executor that miscounts fails too
    ok = [plane.submit("echo", [t], 1, _echo_exec([])) for t in "zw"]
    assert [f.result(timeout=10) for f in ok] == [["z"], ["w"]]
    short = [plane.submit("short", [t], 1, lambda reqs: [None]) for t in "ab"]
    for f in short:
        with pytest.raises(RuntimeError, match="returned 1 results for 2"):
            f.result(timeout=10)


def test_concurrent_submitters_coalesce_and_stay_correct():
    plane = DevicePlane(window_ms=25, high_water=1 << 30, starvation_ms=60_000)
    calls: list[list[int]] = []

    def caller(tag):
        payload = [f"{tag}-{j}" for j in range(tag + 1)]
        return lambda: plane.submit("echo", payload, len(payload), _echo_exec(calls)).result(timeout=20)

    results = _concurrently([caller(t) for t in range(4)])
    assert results == [[f"{t}-{j}" for j in range(t + 1)] for t in range(4)]
    assert sum(len(c) for c in calls) == 4  # every request dispatched once


def test_stress_many_submitters_lose_nothing():
    """32 threads, 50 requests each, a switch interval of a microsecond:
    every request dispatched once, its own payload back, every counter
    exact."""
    plane = DevicePlane(window_ms=0, high_water=64, starvation_ms=60_000)
    dispatched: list[int] = []

    def count_exec(reqs):
        dispatched.extend(r.n for r in reqs)
        return [r.payload for r in reqs]

    def caller(t):
        def run():
            for j in range(50):
                with device_lane(("consensus", "admission", "sync", "proof")[j % 4]):
                    assert plane.submit("op", (t, j), j % 5 + 1, count_exec).result(timeout=60) == (t, j)
            return True

        return run

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert _concurrently([caller(t) for t in range(32)]) == [True] * 32
    finally:
        sys.setswitchinterval(old)
    items = 32 * sum(j % 5 + 1 for j in range(50))
    assert len(dispatched) == 32 * 50 and sum(dispatched) == items
    stats = plane.stats()
    assert stats["requests"] == 32 * 50 and stats["items"] == items and stats["queue_depth"] == 0
    assert plane.drain(timeout=10)


def test_default_window_follows_the_card(monkeypatch):
    monkeypatch.delenv("FISCO_DEVICE_WINDOW_MS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert DevicePlane(autostart=False).window_ms == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert DevicePlane(autostart=False).window_ms == plane_mod.CUDA_WINDOW_MS
    monkeypatch.setenv("FISCO_DEVICE_WINDOW_MS", "0.5")
    monkeypatch.setenv("FISCO_DEVICE_HIGH_WATER", "not-a-number")
    plane = DevicePlane(autostart=False)
    assert plane.window_ms == 0.5 and plane.high_water == 4096 and plane.starvation_ms == 50.0


# -- group-fair deficit round-robin ------------------------------------------


def _drr_plane(**kw) -> DevicePlane:
    kw.setdefault("window_ms", 0)
    kw.setdefault("autostart", False)
    plane = DevicePlane(**kw)
    plane.starvation_ms = 60_000
    return plane


def test_single_group_selection_unchanged():
    plane = _drr_plane(high_water=100)
    with device_group("g0"):
        for i in range(5):
            plane.submit("op", [i], 60, _noop_exec)  # 300 items, past high water
    op, taken, deferred = plane._pick_ready_locked(time.perf_counter())
    assert op == "op" and len(taken) == 5 and deferred == []


def test_drr_bounds_abusive_group_and_serves_victim():
    plane = _drr_plane(high_water=200)
    with device_group("abuser"):
        for i in range(10):
            plane.submit("op", [i], 100, _noop_exec)
    with device_group("victim"):
        plane.submit("op", ["v"], 50, _noop_exec)
    _, taken, deferred = plane._pick_ready_locked(time.perf_counter())
    assert "victim" in [r.group for r in taken]
    assert sum(r.n for r in taken) <= 200 + 100  # the cap, one request over at most
    assert deferred and all(r.group == "abuser" for r in deferred)
    assert plane._pending["op"][0].group == "abuser"
    taken_payloads = [r.payload for r in taken]
    assert [r.payload for r in plane._pending["op"]] == [[i] for i in range(10) if [i] not in taken_payloads]


def test_drr_drains_abuser_eventually_and_resets_deficit():
    plane = _drr_plane(high_water=150)
    with device_group("a"):
        for i in range(6):
            plane.submit("op", [i], 50, _noop_exec)
    with device_group("b"):
        plane.submit("op", ["b0"], 50, _noop_exec)
    seen = []
    for _ in range(10):
        picked = plane._pick_ready_locked(time.perf_counter())
        if picked is None:
            break
        seen.extend(r.payload for r in picked[1])
    assert len(seen) == 7  # nothing lost, nothing twice
    assert "b" not in plane._deficit


def test_drr_weights_shift_share(monkeypatch):
    monkeypatch.setenv("FISCO_DEVICE_GROUP_WEIGHTS", "gold=2, basic=1, bad=x")
    monkeypatch.setenv("FISCO_DEVICE_GROUP_QUANTUM", "50")
    plane = _drr_plane(high_water=300)
    assert plane.group_weights == {"gold": 2.0, "basic": 1.0} and plane.group_quantum == 50
    for group in ("gold", "basic"):
        with device_group(group):
            for i in range(20):
                plane.submit("op", [f"{group}{i}"], 25, _noop_exec)
    _, taken, deferred = plane._pick_ready_locked(time.perf_counter())
    gold = sum(r.n for r in taken if r.group == "gold")
    basic = sum(r.n for r in taken if r.group == "basic")
    assert deferred and gold >= 1.5 * basic, (gold, basic)


def test_drr_respects_lane_priority_between_groups():
    plane = _drr_plane(high_water=100)
    with device_group("bulk"):
        for i in range(5):
            plane.submit("op", [i], 60, _noop_exec)
    with device_group("chain"), device_lane("consensus"):
        plane.submit("op", ["qc"], 10, _noop_exec)
    _, taken, _ = plane._pick_ready_locked(time.perf_counter())
    assert taken[0].lane == "consensus" and taken[0].group == "chain"


def test_drr_deferred_requests_still_dispatch_through_worker():
    plane = DevicePlane(window_ms=0, high_water=120, autostart=True)
    sizes: list[int] = []

    def count_exec(reqs):
        sizes.append(sum(r.n for r in reqs))
        return [r.payload for r in reqs]

    futures = []
    with device_group("a"):
        futures += [plane.submit("op", i, 50, count_exec) for i in range(8)]
    with device_group("b"):
        futures.append(plane.submit("op", "vb", 50, count_exec))
    assert [f.result(timeout=30) for f in futures] == list(range(8)) + ["vb"]
    assert sum(sizes) == 450  # every item dispatched once


# -- the same picks as the JAX plane -----------------------------------------

# (op, lane, group, items, enqueue ms) submissions, the planes' knobs, the
# FISCO_DEVICE_GROUP_* environment and the clock (ms) of each pick
_SAME_PICKS = {
    "lanes": dict(
        subs=[("op.sync", "sync", "", 1, 0.0), ("op.proof", "proof", "", 2, 1.0), ("op.cons", "consensus", "", 1, 2.0),
              ("op.adm", "admission", "", 3, 2.0), ("op.cons", "consensus", "", 4, 2.5)],
        knobs=dict(window_ms=0, high_water=4096, starvation_ms=60_000), picks=[3.0] * 5),
    "starvation": dict(
        subs=[("op.sync", "sync", "", 1, 0.0), ("op.proof", "proof", "", 1, 4.0), ("op.cons", "consensus", "", 1, 15.0),
              ("op.adm", "admission", "", 1, 16.0)],
        knobs=dict(window_ms=0, high_water=4096, starvation_ms=10), picks=[20.0, 20.0, 20.0, 27.0, 27.0]),
    "window and high water": dict(
        subs=[("a", "admission", "", 3, 0.0), ("b", "sync", "", 12, 3.0), ("c", "consensus", "", 1, 4.0)],
        knobs=dict(window_ms=5, high_water=10, starvation_ms=60_000), picks=[4.0, 4.5, 5.5, 6.0, 9.5, 9.5]),
    "DRR abuser and victim": dict(
        subs=[("op", "admission", "abuser", 100, 0.1 * i) for i in range(10)] + [("op", "admission", "victim", 50, 1.0)],
        knobs=dict(window_ms=0, high_water=200, starvation_ms=60_000), picks=[2.0] * 8),
    "DRR weights": dict(
        subs=[("op", "admission", g, 25, 0.01 * i) for g in ("gold", "basic") for i in range(20)],
        knobs=dict(window_ms=0, high_water=300, starvation_ms=60_000), picks=[1.0] * 6,
        env={"FISCO_DEVICE_GROUP_WEIGHTS": "gold=2, basic=1, bad=x", "FISCO_DEVICE_GROUP_QUANTUM": "50"}),
    "DRR lanes between groups": dict(
        subs=[("op", "admission", "bulk", 60, 0.1 * i) for i in range(5)] + [("op", "consensus", "chain", 10, 1.0)],
        knobs=dict(window_ms=0, high_water=100, starvation_ms=60_000), picks=[2.0] * 6),
}


def _seeded_picks(seed: int) -> dict:
    """Three ops, every lane, three groups, ragged sizes and enqueue times;
    a pick every ms until the queues are empty."""
    rng = np.random.default_rng(seed)
    subs = sorted(
        ((f"op{rng.integers(3)}", ("consensus", "admission", "sync", "proof")[rng.integers(4)],
          f"g{rng.integers(3)}", int(rng.integers(1, 120)), float(rng.uniform(0, 30))) for _ in range(60)),
        key=lambda s: s[4],
    )
    return dict(subs=subs, knobs=dict(window_ms=2, high_water=256, starvation_ms=20), picks=[float(t) for t in range(80)],
                env={"FISCO_DEVICE_GROUP_WEIGHTS": "g0=3,g2=0.5", "FISCO_DEVICE_GROUP_QUANTUM": "40"})


for _seed in (1, 2, 3):
    _SAME_PICKS[f"seeded {_seed}"] = _seeded_picks(_seed)


def _picks(module, case: dict, base: float) -> list:
    """Each pick of a `module.DevicePlane` (no worker) over `case`: (op,
    payloads taken, payloads deferred) or None, and the DRR deficits after
    it."""
    plane = module.DevicePlane(autostart=False, **case["knobs"])
    for i, (op, lane, group, n, t_ms) in enumerate(case["subs"]):
        with module.device_lane(lane), module.device_group(group):
            plane.submit(op, i, n, _noop_exec)
        plane._pending[op][-1].t_enq = base + t_ms / 1e3
    out = []
    for t_ms in case["picks"]:
        picked = plane._pick_ready_locked(base + t_ms / 1e3)
        if picked is not None:
            op, taken, deferred = picked
            picked = (op, [r.payload for r in taken], [r.payload for r in deferred])
        out.append((picked, dict(plane._deficit)))
    assert not any(plane._pending.values()), "a case must empty its queues"
    return out


@pytest.mark.parametrize("name", sorted(_SAME_PICKS))
def test_same_picks_as_the_jax_plane(monkeypatch, name):
    """The port's scheduler and the JAX package's, fed the same
    submissions (lanes, groups, sizes, enqueue times, knobs and
    FISCO_DEVICE_GROUP_* values), make the same (op, taken, deferred) on
    every pick and keep the same deficits."""
    from fisco_bcos_tpu.device import plane as jax_plane

    case = _SAME_PICKS[name]
    for key, value in case.get("env", {}).items():
        monkeypatch.setenv(key, value)
    base = time.perf_counter()
    ours = _picks(plane_mod, case, base)
    assert ours == _picks(jax_plane, case, base)
    assert sum(p is not None for p, _ in ours) >= 2


# -- the seams on the CPU ------------------------------------------------------


def _messages(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, 300, n)]


@pytest.mark.parametrize("hasher", sorted(ORACLES))
def test_hash_batches_merge_and_match_direct(install, monkeypatch, hasher):
    """Ragged concurrent callers of hash_batch(_async) share one dispatch;
    each caller's digests equal its direct call's and the oracle's, and a
    caller's merkle tree and addresses ride the plane too."""
    impl = suite.hash_impl_by_name(hasher)
    batches = [_messages(n, seed) for seed, n in enumerate(RAGGED)]
    plane = _merging(install, RAGGED)
    got = _concurrently([lambda b=b: impl.hash_batch_async(b, device="cpu")() for b in batches])
    assert plane.stats()["dispatches"] == 1 and plane.stats()["merged_requests"] == len(RAGGED)
    monkeypatch.setenv("FISCO_DEVICE_PLANE", "0")
    for batch, digests in zip(batches, got):
        np.testing.assert_array_equal(digests, impl.hash_batch(batch, device="cpu"))
        assert [bytes(d) for d in digests] == [ORACLES[hasher](m) for m in batch]
    monkeypatch.delenv("FISCO_DEVICE_PLANE")

    cpu = type(impl)(torch.device("cpu"))
    keys = np.random.default_rng(7).integers(0, 256, (5, 64), dtype=np.uint8)
    leaves = np.random.default_rng(8).integers(0, 256, (40, 32), dtype=np.uint8)
    plane = install(window_ms=0)
    addresses = cpu.address_batch(keys)
    tree = suite.CryptoSuite(cpu, suite.Secp256k1Crypto(torch.device("cpu"))).merkle_tree(leaves)
    assert plane.stats()["requests"] == 2
    assert [bytes(a) for a in addresses] == [ORACLES[hasher](bytes(k))[12:] for k in keys]
    direct = merkle.MerkleTree(leaves, hasher=hasher, device="cpu")
    assert tree.root == direct.root and all(np.array_equal(a, b) for a, b in zip(tree.levels, direct.levels))


def _admission_case(n: int, seed: int):
    payloads = [b"plane tx %d " % (seed * 100 + i) + b"p" * (i * 41 % 150) for i in range(n)]
    sigs, want = [], []
    for i, p in enumerate(payloads):
        d = 0xA11CE + 7919 * (seed * 100 + i)
        r, s, v = ref.ecdsa_sign(keccak256(p), d)
        if i == 1:
            s = 0  # not ok: the zero key and its sender
        sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v]))
        key = ref.privkey_to_pubkey(ref.SECP256K1, d) if i != 1 else (0, 0)
        pub = key[0].to_bytes(32, "big") + key[1].to_bytes(32, "big")
        want.append((keccak256(pub)[12:], i != 1, pub, keccak256(p)))
    return payloads, np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 65), want


def test_admission_merges_three_callers(install):
    cases = [_admission_case(n, seed) for seed, n in enumerate((1, 2, 3))]
    plane = _merging(install, (1, 2, 3))
    got = _concurrently([lambda c=c: admission.admit_batch(c[0], c[1], device="cpu") for c in cases])
    assert plane.stats()["dispatches"] == 1 and plane.stats()["merged_requests"] == 3
    for (_, _, want), out in zip(cases, got):
        assert [len(x) for x in out] == [len(want)] * 4
        for lane, expected in enumerate(want):
            assert (bytes(out[0][lane]), bool(out[1][lane]), bytes(out[2][lane]), bytes(out[3][lane])) == expected
    with pytest.raises(ValueError, match="3 payloads against 2 signatures"):
        admission.admit_batch(cases[2][0], cases[2][1][:2], device="cpu")
    assert plane.stats()["requests"] == 3


def test_batch_verify_merges_three_callers(install):
    calls = []
    for seed, n in enumerate((1, 2, 3)):
        hashes, pubs, sigs, want = [], [], [], []
        for i in range(n):
            d = 0xB0B + 104729 * (seed * 10 + i)
            h = hashlib.sha256(b"verify %d %d" % (seed, i)).digest()
            r, s, v = ref.ecdsa_sign(h, d)
            x, y = ref.privkey_to_pubkey(ref.SECP256K1, d)
            if i == 1:
                h = bytes(32)  # another message: not ok
            hashes.append(h)
            pubs.append(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
            sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v]))
            want.append(ref.ecdsa_verify(h, r, s, (x, y)))
        rows = [np.frombuffer(b"".join(a), np.uint8).reshape(n, -1) for a in (hashes, pubs, sigs)]
        calls.append((rows, want))
    impl = suite.Secp256k1Crypto(torch.device("cpu"))
    plane = _merging(install, (1, 2, 3))
    got = _concurrently([lambda c=c: impl.batch_verify(*c[0]) for c in calls])
    assert plane.stats()["dispatches"] == 1 and plane.stats()["merged_requests"] == 3
    assert [g.tolist() for g in got] == [want for _, want in calls] == [[True], [True, False], [True, False, True]]


def test_a_kernel_error_fails_every_merged_caller(install, monkeypatch):
    """No fallback: the merged batch's failure reaches each of its callers."""

    def broken(*_args, **_kwargs):
        raise RuntimeError("verify kernel launch failed")

    monkeypatch.setattr(secp_ops, "verify_batch", broken)
    impl = suite.Secp256k1Crypto(torch.device("cpu"))
    h, pub, sig = np.zeros((2, 32), np.uint8), np.zeros((2, 64), np.uint8), np.zeros((2, 65), np.uint8)
    plane = _merging(install, (2, 2))

    def caller():
        with pytest.raises(RuntimeError, match="verify kernel launch failed"):
            impl.batch_verify(h, pub, sig)
        return True

    assert _concurrently([caller, caller]) == [True, True] and plane.stats()["dispatches"] == 1


def test_no_cuda_raises_on_the_callers_thread(install, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plane = install(window_ms=0)
    keys = np.zeros((1, 64), np.uint8)
    for call in (
        lambda: suite.Keccak256().hash_batch([b"x"]),
        lambda: suite.Sha256().hash_batch_async([b"x"]),
        lambda: suite.SM3().address_batch(keys),
        lambda: suite.Secp256k1Crypto().batch_verify(np.zeros((1, 32), np.uint8), keys, np.zeros((1, 65), np.uint8)),
        lambda: suite.Ed25519Crypto().batch_verify([b"m"], [bytes(32)], [bytes(64)]),
        lambda: admission.admit_batch([b"x"], np.zeros((1, 65), np.uint8)),
        lambda: admission.admit_batch_sm([b"x"], np.zeros((1, 128), np.uint8)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert plane.stats()["requests"] == 0


def test_passthrough_queues_nothing(install, monkeypatch):
    plane = install(window_ms=0)
    monkeypatch.setenv("FISCO_DEVICE_PLANE", "0")
    assert not plane_mod.plane_enabled() and not plane_mod.plane_route()
    impl = suite.Keccak256(torch.device("cpu"))
    assert [bytes(d) for d in impl.hash_batch([b"direct-1", b"direct-2"])] == [
        keccak256(b"direct-1"), keccak256(b"direct-2")
    ]
    assert plane.stats()["requests"] == 0
    monkeypatch.setenv("FISCO_DEVICE_PLANE", "1")
    with device_lane("sync"):
        impl.hash_batch([b"routed"])
    assert plane.stats()["requests"] == 1


def test_executor_calling_a_routed_seam_goes_direct(install):
    """Ed25519's batch_recover (unrouted) calls batch_verify (routed) from a
    plane executor: the inner call takes the direct path on the worker
    instead of waiting on it, and the result is the oracle's."""
    seeds = [bytes([i + 1]) * 32 for i in range(3)]
    msgs = [b"qc vote %d" % i for i in range(3)]
    sigs = [ref_ed25519.sign(sd, m) + ref_ed25519.seed_to_pubkey(sd) for sd, m in zip(seeds, msgs)]
    sigs[2] = sigs[2][:64] + ref_ed25519.seed_to_pubkey(seeds[0])  # another signer's key: not ok
    impl = suite.Ed25519Crypto(torch.device("cpu"))
    plane = install(window_ms=0)

    def nested(reqs):
        assert plane_mod.in_plane_executor() and not plane_mod.plane_route()
        return [impl.batch_recover(*r.payload) for r in reqs]

    keys, ok = plane.submit("nested", (msgs, sigs), 3, nested).result(timeout=120)
    assert ok.tolist() == [True, True, False]
    assert [bytes(k) for k in keys] == [sigs[0][64:], sigs[1][64:], bytes(32)]
    assert plane.stats()["requests"] == 1  # the inner batch_verify queued nothing
