"""The port's device observatory (``fisco_bcos_tpu_torch/observability``)
held against the JAX package's on the CPU: the build ledger, the metrics
registry's text, the tracer's span tree, ``device_span``'s metric families
and ``device_doc()``'s keys on the same inputs; then the spans of the
port's host entry points (op, batch and shape key as the JAX wrappers
compute them, no nesting the JAX package lacks), the ledger fed by
``ops/_kernels.py``'s build listeners, and the DevicePlane's telemetry.
No JAX program is traced; one plain EC batch runs (``admit_batch``)."""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

from fisco_bcos_tpu import observability as jax_obs
from fisco_bcos_tpu.observability import device as jax_dev
from fisco_bcos_tpu.observability import tracer as jax_tracer
from fisco_bcos_tpu.ops import bls12_381 as jax_bls
from fisco_bcos_tpu.ops import hash_common as jax_hc
from fisco_bcos_tpu.ops import merkle as jax_merkle
from fisco_bcos_tpu.utils import metrics as jax_metrics
from fisco_bcos_tpu_torch import observability as obs
from fisco_bcos_tpu_torch.crypto import admission, bls, suite
from fisco_bcos_tpu_torch.device import plane as plane_mod
from fisco_bcos_tpu_torch.device.plane import DevicePlane
from fisco_bcos_tpu_torch.observability import device as dev_obs
from fisco_bcos_tpu_torch.observability import tracer as port_tracer
from fisco_bcos_tpu_torch.ops import _kernels, ed25519, keccak, merkle, secp256k1, sha256, sm2, sm3
from fisco_bcos_tpu_torch.ops import bls12_381 as bls_ops
from fisco_bcos_tpu_torch.utils import metrics as port_metrics

CPU = torch.device("cpu")


@pytest.fixture
def registries(monkeypatch):
    """Fresh registries as both packages' process-wide ones."""
    jax_reg = jax_metrics.MetricsRegistry(enabled=True)
    port_reg = port_metrics.MetricsRegistry(enabled=True)
    monkeypatch.setattr(jax_metrics, "REGISTRY", jax_reg)
    monkeypatch.setattr(port_metrics, "REGISTRY", port_reg)
    return jax_reg, port_reg


# -- the ledger ----------------------------------------------------------------

# steps: ("push", op, shape, batch), ("pop",), ("event", name),
# ("duration", name, secs), ("tick", seconds), ("phases", op, phases, t0, dur),
# ("adjacency", op), ("storm",) — a storm_state() read mid-sequence
_COLD = [("push", "qc_pairing", (32, "g2"), 32), ("event", "cache_miss"),
         ("duration", "jaxpr_to_mlir_module_duration", 0.002), ("duration", "backend_compile_duration", 3.25),
         ("pop",)]
_HIT = [("push", "qc_pairing", (64, "g2"), 64), ("event", "cache_hit"),
        ("duration", "cache_retrieval_time_sec", 0.05), ("duration", "backend_compile_duration", 0.051), ("pop",)]
_PORT_KINDS = [("push", "keccak256", 32, 4), ("event", "cache_miss"), ("duration", "retrieval", 0.004),
               ("duration", "backend_compile", 2.5), ("pop",), ("tick", 1.0),
               ("push", "keccak256", 32, 4), ("event", "cache_hit"), ("duration", "retrieval", 0.003),
               ("duration", "backend_compile", 0.0), ("pop",)]
_NO_VERDICT = [("push", "no_cache_op", 8, 8), ("duration", "backend_compile_duration", 0.1), ("pop",)]
_UNATTRIBUTED = [("event", "cache_hit"), ("tick", 0.5), ("duration", "backend_compile_duration", 0.01),
                 ("event", "/jax/compilation_cache/cache_misses"), ("duration", "backend_compile", 0.02)]
_PHASES = [("push", "admission", (32, 1), 20), ("pop",), ("phases", "admission", {"compile": 0.0, "execute": 2.5,
           "transfer": 0.25}, 10.0, 0.00275), ("adjacency", "admission.cpu"), ("adjacency", "admission"),
           ("phases", "admission.cpu", {"queue": 0.125}, None, None), ("adjacency", "admission.cpu"),
           ("adjacency", "admission")]


def _storm(bound: int):
    episode = [("push", "storm_op", 8, 8), ("event", "cache_miss"), ("duration", "backend_compile_duration", 0.001),
               ("pop",), ("tick", 0.1)]
    # over the bound: the storm trips; then the window drains and it recovers
    return episode * (bound + 2) + [("storm",), ("tick", 100.0), ("storm",)]


LEDGER_CASES = {
    "cold": _COLD,
    "cache_hit": _HIT,
    "cold_then_hit_port_kinds": _PORT_KINDS,
    "no_verdict_is_cold": _NO_VERDICT,
    "unattributed_across_calls": _UNATTRIBUTED,
    "phases_and_adjacency": _PHASES,
    "storm_trips_and_drains": _storm(len(jax_hc.bucket_ladder(8))),
}


def _drive(ledger, clock: dict, steps) -> list:
    reads = []
    for step in steps:
        kind, args = step[0], step[1:]
        if kind == "push":
            ledger.push(*args)
        elif kind == "pop":
            ledger.pop()
        elif kind == "event":
            ledger.note_event(*args)
        elif kind == "duration":
            ledger.note_duration(*args)
        elif kind == "tick":
            clock["t"] += args[0]
        elif kind == "phases":
            ledger.note_phases(args[0], args[1], t0=args[2], dur=args[3])
        elif kind == "adjacency":
            ledger.note_adjacency(*args)
        elif kind == "storm":
            reads.append(ledger.storm_state())
    return reads


def _ledger_view(ledger, reads: list) -> dict:
    return {
        "snapshot": ledger.snapshot(), "storm": ledger.storm_state(), "phases": ledger.phase_totals(),
        "dispatches": ledger.dispatches(), "adjacency": ledger.adjacency(), "reads": reads,
        "programs": ledger.program_counts(), "cold": ledger.cold_compile_count(),
    }


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_ledger_equals_the_jax_ledger(case, registries):
    """The same event sequence into both ledgers (a fake clock, a 10 s
    storm window, factor 1): equal rows, storm state, phase totals,
    dispatches and adjacency. A storm case drains before it ends, so the
    JAX ledger's health row is back to ok."""
    from fisco_bcos_tpu.resilience import HEALTH

    views = []
    try:
        for mod in (jax_dev, dev_obs):
            clock = {"t": 1000.0}
            led = mod.CompileLedger(clock=lambda c=clock: c["t"], storm_window_s=10.0, storm_factor=1.0)
            reads = _drive(led, clock, LEDGER_CASES[case])
            views.append(_ledger_view(led, reads))
        assert HEALTH.status("device-recompile") != "degraded"
    finally:
        if case.startswith("storm"):
            HEALTH.ok("device-recompile", "test cleanup")
    assert views[0] == views[1]
    if case.startswith("storm"):
        assert views[1]["reads"][0]["active"] and views[1]["reads"][0]["ops"] == ["storm_op"]
        assert not views[1]["reads"][1]["active"]
    if case == "cold":
        (row,) = views[1]["snapshot"]
        assert row["cold_compiles"] == 1 and row["compile_ms"] == 3250.0 and row["lowering_ms"] == 2.0


def test_ledger_frame_accumulates_compile_and_lowering():
    for mod in (jax_dev, dev_obs):
        led = mod.CompileLedger(clock=lambda: 42.0)
        led.push("op", 32, 32)
        led.note_event("cache_miss")
        led.note_duration("jaxpr_to_mlir_module_duration", 0.002)
        led.note_duration("backend_compile_duration", 3.25)
        assert led.pop()["compile_ms"] == 3252.0


# -- the registry ----------------------------------------------------------------


def _registry_calls(reg) -> None:
    reg.counter_add('fisco_x_total{op="a"}', 2.0, help="x things\nsecond line")
    reg.counter_add('fisco_x_total{op="b"}', 1.5)
    reg.counter_add("fisco_plain_total", 1.0)
    reg.gauge_set('fisco_depth{lane="admission"}', 3.0, help="a gauge")
    reg.gauge_fn("fisco_pulled", lambda: 7.25, help='pulled "at" scrape')
    reg.gauge_fn("fisco_broken", lambda: 1 / 0)
    reg.histogram("fisco_empty_ms", help="declared, never observed")
    for v in (0.0, 12.0, 50.0, 149.0, 151.0):
        reg.observe("fisco_lat_ms", v, help="latency", op="keccak256")
    reg.observe("fisco_lat_ms", 75.0, op='odd"label\\', exemplar="ab" * 16)
    reg.observe("fisco_batch", 5.0, buckets=(1.0, 4.0, 16.0, float("inf")), help="batches", op="x", phase="y")


def test_registry_renders_the_jax_text(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)  # the exemplars' timestamp
    regs = (jax_metrics.MetricsRegistry(enabled=True), port_metrics.MetricsRegistry(enabled=True))
    for reg in regs:
        _registry_calls(reg)
    assert regs[0].render() == regs[1].render()
    assert regs[0].render(openmetrics=True) == regs[1].render(openmetrics=True)
    assert regs[0].counters_matching("fisco_x") == regs[1].counters_matching("fisco_x")
    offs = (jax_metrics.MetricsRegistry(enabled=False), port_metrics.MetricsRegistry(enabled=False))
    for reg in offs:
        _registry_calls(reg)
    assert offs[0].render() == offs[1].render()


# -- the tracer ------------------------------------------------------------------


def _trace_tree(mod):
    tr = mod.Tracer(capacity=64, sample_rate=1.0)
    other = tr.new_root_context("other")
    with tr.span("root", batch=4) as root:
        root.set(txs=4)
        with tr.span("child", parent=None, links=(other,), k="v") as child:
            tr.record("retro", t0=1.0, dur=0.5, parent_ctx=child.ctx, op="x")
        with tr.attach(root.ctx):
            with tr.span("attached"):
                pass
    tr.record("lone", t0=2.0, dur=0.25)
    with tr.span("explicit", parent=root.ctx):
        pass
    return tr, other


def _tree_view(tr, other) -> list:
    spans = tr.spans()
    index = {s.span_id: i for i, s in enumerate(spans)}
    return [
        (s.name, s.parent, s.depth, s.attrs, index.get(s.parent_id, "-" if s.parent_id is None else "ext"),
         [("other" if (t, sid) == (other.trace_id, other.span_id) else "?") for t, sid in s.links])
        for s in spans
    ]


def test_tracer_tree_equals_the_jax_tree():
    trees = [_trace_tree(mod) for mod in (jax_tracer, port_tracer)]
    views = [_tree_view(*t) for t in trees]
    assert views[0] == views[1] and len(views[0]) == 6
    chromes = [tr.export_chrome() for tr, _ in trees]
    assert chromes[0].keys() == chromes[1].keys()
    for a, b in zip(chromes[0]["traceEvents"], chromes[1]["traceEvents"], strict=True):
        assert a.keys() == b.keys() and a["args"].keys() == b["args"].keys() and a["name"] == b["name"]
    ctx = port_tracer.TraceContext(0x1234, 0x56, True)
    assert ctx.traceparent() == jax_tracer.TraceContext(0x1234, 0x56, True).traceparent()
    assert port_tracer.TraceContext.from_traceparent(ctx.traceparent()).span_id == 0x56
    assert port_tracer.TraceContext.from_traceparent("garbage") is None
    drops = []
    for mod in (jax_tracer, port_tracer):
        tr = mod.Tracer(capacity=2, sample_rate=0.0)
        with tr.span("skipped"):
            pass
        tr.sample_rate = 1.0
        for i in range(3):
            tr.record(f"r{i}", t0=0.0, dur=0.0)
        drops.append(tr.drop_counts())
    assert drops[0] == drops[1] == {"sampled": 1, "ring_evict": 1}


# -- device_span -----------------------------------------------------------------


def _families(reg) -> dict:
    """Counter series -> value (the wall-seconds counter by name only) and
    histogram family -> {label set: count}."""
    out = {name: (None if "seconds_total" in name else v) for name, v in reg._counters.items()}
    for name, h in reg._histograms.items():
        out[name] = {key: snap[2] for key, snap in h.snapshot().items()}
    return out


def _drive_span(mod, op: str) -> None:
    with mod.device_span(op, 16, queue_ms=1.25) as sp:
        with sp.phase("transfer"):
            time.sleep(0.002)
        mod.LEDGER.note_event("cache_miss")
        mod.LEDGER.note_duration("backend_compile_duration", 0.004)
    with mod.device_span(op, 9):  # the same bucket: a repeat-shape call
        pass
    with pytest.raises(KeyError):
        with mod.device_span(op, 3):
            raise KeyError("an exception leaves the span unswallowed")


def test_device_span_families_equal_the_jax_ones(registries):
    op = "obs_family_test_op"
    _drive_span(jax_dev, op)
    _drive_span(dev_obs, op)
    fams = [_families(r) for r in registries]
    assert fams[0] == fams[1]
    assert fams[1]['fisco_device_items_total{op="obs_family_test_op"}'] == 25.0
    assert set(fams[1]["fisco_device_phase_ms"]) == {
        (("op", op), ("phase", p)) for p in ("queue", "compile", "transfer", "execute")
    }
    totals = dev_obs.LEDGER.phase_totals()[op]
    assert totals["compile"] == 4.0 and totals["queue"] == 1.25 and totals["transfer"] >= 2.0
    names = {s.name for s in obs.TRACER.spans()}
    assert {f"device.{op}", f"device.{op}.transfer", f"device.{op}.execute", f"device.{op}.compile"} <= names
    shapes = {jax_hc.bucket_batch(n) for n in (16, 9, 3)}
    assert jax_dev.compile_counts()[op] == dev_obs.compile_counts()[op] == len(shapes)


@pytest.fixture
def fresh_hooks(monkeypatch):
    """An empty list of build listeners, the observatory's not yet in it."""
    monkeypatch.setattr(_kernels, "BUILD_LISTENERS", [])
    monkeypatch.setattr(dev_obs, "_HOOKS_INSTALLED", False)
    return _kernels.BUILD_LISTENERS


def test_device_obs_off_is_a_noop(monkeypatch, registries, fresh_hooks):
    monkeypatch.setenv("FISCO_DEVICE_OBS", "0")
    op = "obs_off_test_op"
    dev_obs.install_build_hooks()
    with dev_obs.device_span(op, 8) as sp:
        with sp.phase("transfer"):
            pass
        for listener in _kernels.BUILD_LISTENERS:  # a build inside the span
            listener("cache_miss")
            listener("backend_compile", 1.0)
    assert op not in dev_obs.LEDGER.phase_totals()
    assert op not in dev_obs.LEDGER.program_counts()
    h = registries[1].histogram("fisco_device_phase_ms")
    assert not any(("op", op) in key for key in h.snapshot())
    doc = dev_obs.device_doc()
    assert doc["enabled"] is False and doc["ledger"] == [] and doc["memory"] == {}
    assert op in dev_obs.compile_counts()  # the registry's layer is FISCO_TELEMETRY's
    assert dev_obs.install_observatory() is False


def test_device_doc_has_the_jax_keys():
    jax_doc, doc = jax_dev.device_doc(), dev_obs.device_doc()
    assert doc.keys() == jax_doc.keys()
    for key in ("totals", "memory", "storm"):
        assert doc[key].keys() == jax_doc[key].keys(), key
    assert doc["memory"] == {"live_bytes": {}, "watermarks": {}}  # no CUDA context on the CPU
    assert doc["plane"].keys() == jax_doc["plane"].keys()
    assert dev_obs.device_memory_bytes() == {} and not torch.cuda.is_initialized()


def test_observability_package_mirrors_the_jax_one():
    names = ("BATCH_BUCKETS", "LATENCY_BUCKETS_MS", "Histogram", "TRACER", "SpanRecord", "TraceContext",
             "Tracer", "current_context", "set_enabled", "telemetry_enabled")
    assert all(hasattr(obs, n) and hasattr(jax_obs, n) for n in names)
    assert obs.BATCH_BUCKETS == jax_obs.BATCH_BUCKETS and obs.LATENCY_BUCKETS_MS == jax_obs.LATENCY_BUCKETS_MS
    assert dev_obs.DEVICE_PHASE_BUCKETS_MS == jax_dev.DEVICE_PHASE_BUCKETS_MS
    assert dev_obs.DEVICE_COMPILE_BUCKETS_MS == jax_dev.DEVICE_COMPILE_BUCKETS_MS
    try:
        obs.set_enabled(False)
        assert not obs.telemetry_enabled() and obs.TRACER.span("x") is port_tracer._NOOP
    finally:
        obs.set_enabled(True)
    for n in (1, 2, 31, 32, 33, 700, 2048, 2049, 10_240):
        assert dev_obs.bucket_ladder(n) == jax_hc.bucket_ladder(n)


# -- the port's entry points ----------------------------------------------------


@pytest.fixture
def pushes(monkeypatch):
    """Every device_span of the port, as (op, shape key, batch) in order;
    the trace ring cleared."""
    got: list = []
    real = dev_obs.LEDGER.push

    def spy(op, shape_key, batch):
        got.append((op, shape_key, batch))
        return real(op, shape_key, batch)

    monkeypatch.setattr(dev_obs.LEDGER, "push", spy)
    obs.TRACER.clear()
    return got


def _no_nesting() -> None:
    """No device.<op> span sits under another device.<op> span: each one's
    parent is nothing or the plane's dispatch."""
    spans = obs.TRACER.spans()
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name.startswith("device.") and s.name.count(".") == 1:
            parent = by_id.get(s.parent_id)
            assert parent is None or parent.name == "device.plane.dispatch", (s.name, parent.name)


MSGS = [b"", b"abc", b"x" * 136, b"y" * 300]


def test_hash_and_merkle_entry_points_emit_their_jax_spans(pushes):
    b4 = jax_hc.bucket_batch(4)
    keccak.keccak256_batch(MSGS, device="cpu")
    sm3.sm3_batch(MSGS, device="cpu")
    sha256.sha256_batch(MSGS, device="cpu")
    leaves = np.arange(4 * 32, dtype=np.uint8).reshape(4, 32)
    merkle.merkle_root(leaves, device="cpu")
    merkle.merkle_root(leaves, hasher="sm3", width=2, device="cpu")
    suite.ecdsa_suite("cpu").merkle_tree(leaves)
    assert pushes == [
        ("keccak256", b4, 4), ("sm3", b4, 4), ("sha256", b4, 4),
        ("merkle_root", ("keccak256", 16, jax_merkle.bucket_leaves(4)), 4),
        ("merkle_root", ("sm3", 2, jax_merkle.bucket_leaves(4)), 4),
        ("merkle_tree", ("keccak256", jax_merkle.bucket_leaves(4)), 4),
    ]
    _no_nesting()
    names = [s.name for s in obs.TRACER.spans() if s.name.count(".") == 1]
    assert names.count("device.merkle_root") == 2 and names.count("device.keccak256") == 1


def test_suite_hash_seams_emit_the_hash_span(pushes, monkeypatch):
    """A routed hash batch, the plane off and the address batch each give
    one span of the hash's name, keyed by the batch bucket (the JAX hash
    executor's and ``_batch_direct``'s)."""
    b4 = jax_hc.bucket_batch(4)
    impl = suite.SM3(CPU)
    impl.hash_batch(MSGS)
    monkeypatch.setenv("FISCO_DEVICE_PLANE", "0")
    impl.hash_batch(MSGS)
    impl.address_batch(np.zeros((4, 64), np.uint8))
    suite.Sha256(CPU).address_batch(np.ones((4, 64), np.uint8))
    assert pushes == [("sm3", b4, 4)] * 3 + [("sha256", b4, 4)]
    _no_nesting()


def test_admit_batch_emits_one_admission_span(pushes):
    """admit_batch through the plane: one ``admission`` span on the worker,
    keyed (bucketed batch, bucketed block count) as the JAX span is, from
    the shape JAX ``pad_keccak`` gives the same payloads; no hash or
    recover span inside it."""
    payloads = [b"p" * n for n in (10, 200, 300, 97)]
    sigs = np.arange(4 * 65, dtype=np.uint8).reshape(4, 65)
    admission.admit_batch(payloads, sigs, device="cpu")
    blocks, _ = jax_hc.pad_keccak(payloads)
    assert pushes == [("admission", (blocks.shape[0], blocks.shape[1]), 4)]
    (span,) = [s for s in obs.TRACER.spans() if s.name == "device.admission"]
    assert span.attrs == {"batch": 4}
    _no_nesting()


def _ones(n):
    return torch.ones(n, dtype=torch.bool)


def test_ec_entry_points_emit_their_jax_spans(pushes, monkeypatch):
    """With the EC kernels' plain versions faked (the span is what is
    tested, not the arithmetic): each entry point's one span, its key and
    its transfer phase where JAX marks one; SM2's has no sm3 span inside,
    and ``admit_batch_sm`` gives the one ``sm2_verify`` span of its fused
    body."""
    monkeypatch.setattr(secp256k1, "verify_device", lambda rows: _ones(rows.shape[0]))
    monkeypatch.setattr(secp256k1, "recover_device", lambda z, r, s, v: (z, z, _ones(z.shape[0])))
    monkeypatch.setattr(sm2, "verify_device", lambda e, r, s, qx, qy: _ones(e.shape[0]))
    monkeypatch.setattr(ed25519, "challenge_device", lambda rows, *packed: rows)
    monkeypatch.setattr(ed25519, "verify_device", lambda rows: _ones(rows.shape[0]))
    h = np.zeros((3, 32), np.uint8)
    b3 = jax_hc.bucket_batch(3)
    secp256k1.verify_batch(h, h, h, np.zeros((3, 64), np.uint8), device="cpu")
    secp256k1.recover_batch(h, np.zeros((3, 65), np.uint8), device="cpu")
    sm2.verify_batch(h, h, h, np.zeros((3, 64), np.uint8), device="cpu")
    ed25519.verify_batch([b"m"] * 3, [bytes(32)] * 3, [bytes(64)] * 3, device="cpu")
    admission.admit_batch_sm([b"a", b"b", b"c"], np.zeros((3, 128), np.uint8), device="cpu")
    assert pushes == [("secp256k1_verify", b3, 3), ("secp256k1_recover", b3, 3), ("sm2_verify", b3, 3),
                      ("ed25519_verify", b3, 3), ("sm2_verify", b3, 3)]
    names = [s.name for s in obs.TRACER.spans()]
    for op in ("secp256k1_verify", "secp256k1_recover", "sm2_verify"):
        assert f"device.{op}.transfer" in names
    assert names.count("device.sm2_verify.transfer") == 2 and "device.sm3" not in names
    _no_nesting()


def test_bls_entry_points_emit_their_jax_spans(pushes, monkeypatch):
    """The QC check gives ``bls_aggregate_verify`` keyed by the batch bucket
    (a set in which nothing decodes too: the JAX span wraps its batch
    whatever the lanes); the multi-pairing ``bls_multi_pairing`` keyed by
    the JAX ``multi_pairing_pad`` of its pair count."""
    crypto = bls.BLSCrypto(device="cpu")
    assert not crypto.aggregate_verify_batch([((bytes(48),), b"m", bytes(96))] * 2).any()
    monkeypatch.setattr(bls, "multi_pairing_pairs", lambda checks: [("p", "q")] * (len(checks) + 1))
    monkeypatch.setattr(bls_ops, "multi_pairing_check", lambda pairs, device=None: True)
    assert crypto.multi_pairing_verify([((bytes(48),), b"m", bytes(96))] * 4)
    assert pushes == [("bls_aggregate_verify", jax_hc.bucket_batch(2), 2),
                      ("bls_multi_pairing", jax_bls.multi_pairing_pad(5), 5)]
    assert bls_ops.multi_pairing_pad(5) == 8
    assert [bls_ops.multi_pairing_pad(n) for n in range(70)] == [jax_bls.multi_pairing_pad(n) for n in range(70)]
    _no_nesting()


# -- builds ----------------------------------------------------------------------


class _StubLibrary:  # an attribute appears where the loader asks for one
    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_library_builds_feed_the_ledger_under_the_enclosing_span(monkeypatch, fresh_hooks):
    """``_library``'s first use tells the listeners the JAX sequence: a
    cold build (nvcc ran) then a cache hit (the library already built),
    each landing under the op of the span around it, compile = nvcc's
    seconds, the load as retrieval; a loaded library tells nothing more."""
    builds = iter([{"seconds": 1.5, "log": "", "cached": False}, {"seconds": 0.0, "log": "", "cached": True}])
    monkeypatch.setattr(_kernels, "build", lambda name: next(builds))
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: _StubLibrary())
    monkeypatch.setattr(_kernels, "_LIBS", {})
    heard = []
    fresh_hooks.append(lambda *a: heard.append(a))
    assert dev_obs.install_build_hooks() and dev_obs.install_build_hooks()  # idempotent
    assert len(fresh_hooks) == 2
    assert _kernels.BUILD_LISTENERS[-1] is dev_obs._on_build
    dev_obs.LEDGER.reset()
    with dev_obs.device_span("keccak256", 4, shape_key=32):
        _kernels._library("keccak256")
        _kernels._library("keccak256")  # loaded: nothing more
    monkeypatch.setattr(_kernels, "_LIBS", {})
    with dev_obs.device_span("sha256", 4, shape_key=32):
        _kernels._library("sha256")
    assert [a[0] for a in heard] == ["cache_miss", "retrieval", "backend_compile",
                                     "cache_hit", "retrieval", "backend_compile"]
    assert heard[2] == ("backend_compile", 1.5) and heard[5] == ("backend_compile", 0.0)
    rows = {r["op"]: r for r in dev_obs.LEDGER.snapshot()}
    assert rows.keys() == {"keccak256", "sha256"}
    cold, hit = rows["keccak256"], rows["sha256"]
    assert (cold["cold_compiles"], cold["cache_hits"], cold["compile_ms"], cold["last_source"]) == (1, 0, 1500.0, "cold")
    assert (hit["cold_compiles"], hit["cache_hits"], hit["compile_ms"], hit["last_source"]) == (
        0, 1, 0.0, "persistent_cache")
    assert cold["shape"] == "32" and cold["retrieval_ms"] >= 0.0
    assert dev_obs.LEDGER.phase_totals()["keccak256"]["compile"] == 1500.0
    assert dev_obs.LEDGER.cold_compile_count() == 1


# -- the plane -------------------------------------------------------------------


def test_plane_dispatch_telemetry(monkeypatch, registries):
    """Three callers, each under a trace of its own, merged into one
    dispatch of a routed CPU hash: the queue phase under the plane op, the
    adjacency edge plane op -> hash op, the dispatch span linked to every
    caller with the ``device.keccak256`` span beneath it, one wait record a
    caller naming the dispatch, and the plane's metrics."""
    msgs = [MSGS[:1], MSGS[1:3], MSGS]
    plane = DevicePlane(window_ms=60_000, high_water=sum(map(len, msgs)))
    monkeypatch.setattr(plane_mod, "_PLANE", plane)
    dev_obs.LEDGER.reset()
    obs.TRACER.clear()
    impl = suite.Keccak256(CPU)
    out, ctxs = [None] * 3, [None] * 3

    def call(i):
        with obs.TRACER.span(f"caller{i}") as sp:
            ctxs[i] = sp.ctx
            out[i] = impl.hash_batch(msgs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and plane.stats()["dispatches"] == 1
    assert plane.drain(10.0)
    op = "hash.keccak256.cpu"
    phases = dev_obs.LEDGER.phase_totals()
    assert phases[op]["queue"] > 0.0 and phases["keccak256"]["execute"] > 0.0
    assert dev_obs.LEDGER.adjacency() == {f"{op}->keccak256": 1}
    spans = obs.TRACER.spans()
    (dispatch,) = [s for s in spans if s.name == "device.plane.dispatch"]
    (kernel_span,) = [s for s in spans if s.name == "device.keccak256"]
    assert kernel_span.parent_id == dispatch.span_id and kernel_span.attrs == {"batch": 7}
    assert dispatch.attrs == {"op": op, "requests": 3, "items": 7}
    assert sorted(dispatch.links) == sorted((c.trace_id, c.span_id) for c in ctxs)
    waits = [s for s in spans if s.name == "device.plane.wait"]
    assert sorted(w.parent_id for w in waits) == sorted(c.span_id for c in ctxs)
    assert all(w.attrs["batch_span"] == f"{dispatch.span_id:016x}" and w.attrs["op"] == op for w in waits)
    reg = registries[1]
    assert reg.counters_matching("fisco_device_plane_requests_total") == {
        f'fisco_device_plane_requests_total{{op="{op}",lane="admission"}}': 3.0}
    assert reg.counters_matching("fisco_device_plane_dispatch_total") == {
        f'fisco_device_plane_dispatch_total{{op="{op}"}}': 1.0}
    assert reg.counters_matching("fisco_device_plane_coalesced_total") == {
        f'fisco_device_plane_coalesced_total{{op="{op}"}}': 3.0}
    for family, count in (("fisco_device_plane_wait_ms", 3), ("fisco_device_plane_batch_items", 1),
                          ("fisco_device_plane_bucket_occupancy", 1)):
        assert sum(c for _, _, c in reg.histogram(family).snapshot().values()) == count, family
    assert (("op", op), ("phase", "queue")) in reg.histogram("fisco_device_phase_ms").snapshot()


def test_queue_depth_gauge_is_the_singletons(monkeypatch, registries):
    monkeypatch.setattr(plane_mod, "_PLANE", None)
    DevicePlane(autostart=False)  # a throwaway plane registers nothing
    assert "fisco_device_plane_queue_depth" not in registries[1].render()
    plane = plane_mod.get_plane()
    plane._autostart = False
    plane.submit("gauge_op", [1], 5, lambda reqs: [None] * len(reqs))
    assert "fisco_device_plane_queue_depth 5" in registries[1].render()
    with plane._cv:
        plane._pending.clear()
