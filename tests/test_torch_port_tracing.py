"""The port's own spans and counts (``fit_tpu_torch.utils.profiling``), the
server's and the Trainer's use of them, and the benchmark's readers of
them.

1. The recorder: nested spans, the recording thread's native id, the
   buffer's bound, ``recorded``'s clipping, ``enable(False)``; the kernel
   wrappers' launch counters in the ops package's one registry.
2. A tiny CPU ``SamplingServer`` with a VAE: the worker's spans cover its
   loop one at a time, the counts equal ``stats()``, and ``stats()`` does
   not depend on the recorder.
3. The Trainer loop's ``train.loader_wait`` spans and its
   ``loader_wait_share`` log field.
4. The shared clock: a span around a torch op, mapped onto a CPU
   ``torch.profiler`` trace through the slice's ``t_open`` as
   ``bench_torch.trace.profiled_slice`` stamps it, contains the op's
   ``cpu_op`` event, on the same thread id.
5. The five per-layer readers under ``bench_torch/metrics/`` on a
   hand-built trace and recorder: their exact values, and None when the
   program records nothing.
"""

import json
import os
import tempfile
import threading
import time

import pytest
import torch
from test_torch_port_train import fit, logged, tiny_models, trainer_cfg, write_latents  # noqa: F401 — fixture

from bench_torch.run import read_metric
from bench_torch.trace import SLICE, Trace
from fit_tpu_torch import ops
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.ops import attention, fused_adaln, quant, rope_attention
from fit_tpu_torch.serve import SamplingServer
from fit_tpu_torch.utils import profiling
from fit_tpu_torch.vae import AutoencoderKL

WAIT = 60  # seconds any future may take before the test fails
WORKER_SPANS = ("serve.collect", "serve.noise", "serve.enqueue", "serve.decode", "serve.readback", "serve.resolve")


# -- 1. the recorder ---------------------------------------------------------


def test_spans_nest_and_carry_their_attributes():
    rec = profiling.Recorder()
    with rec.span("outer", id=7, a=1) as outer:
        with rec.span("inner", id=7):
            time.sleep(0.001)
        outer.attrs["b"] = 2
    inner, out = rec.recorded()  # recorded as each closes
    assert (inner.name, out.name) == ("inner", "outer")
    assert out.t0 <= inner.t0 < inner.t1 <= out.t1 and inner.t1 - inner.t0 >= 0.001
    assert (out.kind, out.id, out.attrs) == (profiling.SPAN, 7, {"a": 1, "b": 2})
    rec.count("things", 3, id=7)
    c = rec.recorded()[-1]
    assert (c.kind, c.t0 == c.t1, c.attrs["n"]) == (profiling.COUNT, True, 3)


def test_entries_carry_the_recording_threads_native_id():
    rec = profiling.Recorder()
    seen = []

    def work():
        seen.append(threading.get_native_id())
        with rec.span("there"):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive()
    with rec.span("here"):
        pass
    there, here = rec.recorded()
    assert there.tid == seen[0] == t.native_id and here.tid == threading.get_native_id() != there.tid


def test_the_buffer_keeps_the_newest_entries():
    rec = profiling.Recorder(maxlen=8)
    for i in range(20):
        rec.record("x", float(i), float(i) + 0.5, id=i)
    assert [e.id for e in rec.recorded()] == list(range(12, 20))
    assert profiling.RECORDER._entries.maxlen == 65_536


@pytest.mark.parametrize(
    "t0,t1,want",
    [(None, None, [0, 1, 2, 3]), (1.5, None, [1, 2, 3]), (None, 1.0, [0, 1]), (1.2, 2.1, [1, 2]), (5.0, 6.0, [])],
)
def test_recorded_returns_what_overlaps_the_interval(t0, t1, want):
    rec = profiling.Recorder()
    for i, (s, e) in enumerate([(0.0, 0.5), (1.0, 2.0), (2.1, 2.1), (2.5, 3.0)]):
        rec.record("x", s, e, id=i)
    assert [e.id for e in rec.recorded(t0, t1)] == want


def test_a_disabled_recorder_records_nothing():
    rec = profiling.Recorder()
    assert rec.enable(False) is True
    with rec.span("x") as s:
        pass
    rec.record("y", 0.0, 1.0)
    rec.count("z")
    assert rec.recorded() == [] and s.t0 > 0  # a span still times its block
    assert rec.enable(True) is False
    rec.count("z")
    assert len(rec.recorded()) == 1
    rec.clear()
    assert rec.recorded() == []


COUNTERS = [
    (rope_attention, "launches", "rope_attention_fwd"),
    (rope_attention, "bwd_launches", "rope_attention_bwd"),
    (rope_attention, "flash_launches", "rope_flash_attention"),
    (attention, "launches", "masked_attention"),
    (quant, "launches", "adaln_quant"),
    (quant, "launches", "silu_mul_quant"),
    (fused_adaln, "launches", "adaln_modulate"),
    (fused_adaln, "launches", "swiglu_glue"),
]


@pytest.mark.parametrize("module,attr,kernel", COUNTERS, ids=[c[2] for c in COUNTERS])
def test_launch_counters_share_one_registry(module, attr, kernel):
    """Each wrapper's count is one entry of ``ops.LAUNCHES``, read with the
    name and value ``ops.launch_counts()`` and the module attribute had;
    ``reset_launches`` zeroes its module's. The recorder plays no part."""
    module.reset_launches()
    was = profiling.enable(False)
    try:
        ops.LAUNCHES[kernel] += 3
    finally:
        profiling.enable(was)
    value = getattr(module, attr)
    assert (value[kernel] if isinstance(value, dict) else value) == 3
    assert ops.launch_counts()[kernel] == 3 and list(ops.launch_counts()) == list(ops.KERNELS)
    module.reset_launches()
    assert ops.launch_counts()[kernel] == 0
    with pytest.raises(AttributeError):
        module.no_such_counter  # noqa: B018


# -- 2. the server -----------------------------------------------------------


def tiny_fit():
    model = FiT(patch_size=2, hidden_size=96, depth=2, num_heads=6, num_classes=10, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(2))
    return model


@pytest.fixture(scope="module")
def served():
    """Two waves of requests through a server with a VAE (the second
    after the first is answered, so a read-back splits a collect span),
    then a close; the worker's entries, its stats and the requests."""
    torch.manual_seed(0)
    vae = AutoencoderKL(block_out_channels=(32, 32), device="cpu")
    t0 = time.perf_counter()
    srv = SamplingServer(tiny_fit(), batch_size=4, max_batch_wait_s=0.05, num_sampling_steps=2, num_classes=10,
                         max_size=8, max_length=16, device="cpu", vae=vae)
    try:
        first = [srv.submit(i, 64, 64, seed=i) for i in range(3)]
        for f in first:
            f.result(timeout=WAIT)
        time.sleep(0.2)
        second = [srv.submit(i, *hw, seed=10 + i) for i, hw in enumerate([(64, 64), (48, 80), (48, 80), (64, 64),
                                                                           (48, 80)])]
        for f in second:
            f.result(timeout=WAIT)
    finally:
        srv.close()
    assert not srv._thread.is_alive()
    tid = srv._thread.native_id
    entries = [e for e in profiling.recorded(t0) if e.tid == tid]
    return entries, srv.stats(), 8


def test_the_workers_spans_cover_its_loop_one_at_a_time(served):
    entries, _, _ = served
    spans = sorted((e for e in entries if e.kind == profiling.SPAN and e.name in WORKER_SPANS), key=lambda e: e.t0)
    assert {e.name for e in spans} == set(WORKER_SPANS)
    for a, b in zip(spans, spans[1:]):
        assert a.t1 <= b.t0, (a, b)  # no overlap
        assert b.t0 - a.t1 < 0.025, (a, b)  # no hole: a few lines of the loop between spans
    assert spans[0].name == spans[-1].name == "serve.collect"
    # a batch's spans run in the loop's order, and every batch was decoded
    # and read back once
    batches = sorted({e.id for e in spans if e.name == "serve.enqueue"})
    assert len(batches) >= 2
    for bid in batches:
        names = [e.name for e in spans if e.id == bid and e.name != "serve.collect"]
        assert names[:2] == ["serve.noise", "serve.enqueue"] and names[-2:] == ["serve.readback", "serve.resolve"]
        assert set(names[2:-2]) == {"serve.decode"}


def test_the_counts_equal_the_servers_stats(served):
    entries, stats, n = served
    counts = {}
    for e in entries:
        if e.kind == profiling.COUNT:
            counts[e.name] = counts.get(e.name, 0) + e.attrs["n"]
    decodes = [e for e in entries if e.name == "serve.decode"]
    assert counts["serve.images"] == stats["served"] == n
    assert set(counts) == {"serve.images", "vae.decoded_rows"}
    assert counts["vae.decoded_rows"] == sum(e.attrs["rows"] for e in decodes) == 4 * len(decodes)
    assert sum(e.attrs["images"] for e in decodes) == n


def test_stats_leave_out_the_warmup_and_other_servers():
    model = tiny_fit()
    with SamplingServer(model, batch_size=2, max_batch_wait_s=0.0, num_sampling_steps=2, num_classes=10,
                        max_size=8, max_length=16, device="cpu") as other:
        other.submit(1, 64, 64, seed=1).result(timeout=WAIT)
    with SamplingServer(model, batch_size=2, max_batch_wait_s=0.0, num_sampling_steps=2, num_classes=10,
                        max_size=8, max_length=16, device="cpu") as srv:
        srv.warmup(sizes=[(64, 64)], timeout=WAIT)
        assert "latency_p50_s" not in srv.stats()
        srv.submit(2, 64, 64, seed=2).result(timeout=WAIT)
    s = srv.stats()
    assert s["served"] == 1 and s["latency_p50_s"] == s["latency_p95_s"] > 0


def test_stats_do_not_depend_on_the_recorder():
    """With the recorder off the server records no span, and ``stats()``
    still gives its latencies; the warm-up leaves its ``serve.warmup``
    span while the recorder is on."""
    model = tiny_fit()
    t0 = time.perf_counter()
    with SamplingServer(model, batch_size=2, max_batch_wait_s=0.0, num_sampling_steps=2, num_classes=10,
                        max_size=8, max_length=16, device="cpu") as srv:
        spent = srv.warmup(sizes=[(64, 64)], timeout=WAIT)
        warm = [e for e in profiling.recorded(t0) if e.name == "serve.warmup"]
        assert len(warm) == 1 and warm[0].t1 - warm[0].t0 == pytest.approx(spent, abs=0.05)
        was = profiling.enable(False)
        try:
            t1 = time.perf_counter()
            for i in range(3):
                srv.submit(i, 64, 64, seed=i).result(timeout=WAIT)
            s = srv.stats()
            t2 = time.perf_counter()
        finally:
            profiling.enable(was)
    mine = [e for e in profiling.recorded(t1, t2) if e.tid == srv._thread.native_id and e.t1 <= t2]
    assert mine == [] and s["served"] == 3 and 0 < s["latency_p50_s"] <= s["latency_p95_s"]


# -- 3. the Trainer ----------------------------------------------------------


@pytest.mark.parametrize("on", [True, False], ids=["recorder-on", "recorder-off"])
def test_the_trainer_logs_its_loader_wait(tmp_path, tiny_models, on):  # noqa: F811 — the imported fixture
    root = tmp_path / "latents"
    write_latents(root, n_per_class=4)
    t0 = time.perf_counter()
    was = profiling.enable(on)
    try:
        state = fit(trainer_cfg(root, tmp_path / "run", num_workers=1), 3)
    finally:
        profiling.enable(was)
    assert state.step == 3
    shares = logged(tmp_path / "run", "loader_wait_share")
    if not on:
        assert shares == {} and len(logged(tmp_path / "run")) == 3
        return
    assert sorted(shares) == [1, 2, 3] and all(0.0 <= v < 1.0 for v in shares.values())
    waits = [e for e in profiling.recorded(t0) if e.name == "train.loader_wait"]
    assert len(waits) >= 3 and len({e.tid for e in waits}) == 1  # the loop's thread


def test_loader_wait_s_clips_this_threads_waits(monkeypatch):
    from fit_tpu_torch.train import loop

    rec = profiling.Recorder()
    me = threading.get_native_id()
    rec._entries.extend([
        profiling.Entry("train.loader_wait", profiling.SPAN, me, 0.5, 1.5, None, {}),
        profiling.Entry("train.loader_wait", profiling.SPAN, me, 2.0, 2.25, None, {}),
        profiling.Entry("train.loader_wait", profiling.SPAN, me + 1, 2.0, 3.0, None, {}),  # another thread
        profiling.Entry("serve.collect", profiling.SPAN, me, 1.5, 2.0, None, {}),  # another span
    ])
    monkeypatch.setattr(profiling, "recorded", rec.recorded)
    assert loop.loader_wait_s(1.0, 3.0) == pytest.approx(0.75)


# -- 4. the shared clock -----------------------------------------------------


def _profiled(work):
    """``work()`` under a CPU profiler slice opened as the benchmark's
    ``profiled_slice`` opens it; the Trace and the recorder's entries."""
    from torch.profiler import ProfilerActivity, profile, record_function

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(SLICE):
            t_open = time.perf_counter()
            work()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = Trace(json.load(f)["traceEvents"], t_open)
    finally:
        os.unlink(path)
    return trace, profiling.recorded(t)


def test_a_span_maps_onto_the_profilers_clock_and_thread():
    """The slice's ``t_open`` is stamped just after its range opens; the
    first range a process opens costs about a millisecond of lazy set-up
    between the two, so a first slice (its numbers unused) comes before."""
    a = torch.randn(128, 128)

    def work():
        for i in range(3):
            with profiling.span("clock.check", id=i):
                torch.mm(a, a)
            time.sleep(0.002)

    _profiled(work)
    trace, entries = _profiled(work)
    spans = sorted((e for e in entries if e.name == "clock.check"), key=lambda e: e.t0)
    ops_ = sorted((e for e in trace.host if e["name"] == "aten::mm"), key=lambda e: e["ts"])
    assert len(spans) == len(ops_) == 3
    for s, op in zip(spans, ops_):
        lo = (s.t0 - trace.t_open) * 1e6 + trace.t0
        hi = (s.t1 - trace.t_open) * 1e6 + trace.t0
        assert lo - 100 <= op["ts"] and op["ts"] + op["dur"] <= hi + 100, (lo, hi, op["ts"], op["dur"])
        assert op["tid"] == s.tid


# -- 5. the readers ----------------------------------------------------------

T_OPEN = 50.0
WIN = 10_000  # the slice, in µs from the trace's 1000


def at(us: float) -> float:
    """The perf_counter second of a trace microsecond."""
    return T_OPEN + (us - 1000) * 1e-6


def hand_trace():
    """A 10 ms slice at 1000 µs; kernels 3000–5000 (launched at 2500) and
    7000–10000 (launched at 6000): busy 5 ms, idle 50%."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": SLICE, "ts": 1000.0, "dur": float(WIN), "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 3000.0, "dur": 2000.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 7000.0, "dur": 3000.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2500.0, "dur": 5.0, "tid": 9,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6000.0, "dur": 5.0, "tid": 9,
         "args": {"correlation": 2}},
    ]
    return Trace(ev, T_OPEN)


def hand_recorder():
    """The server's warm-up and the counts of the window after it, the
    worker's spans in the slice (collect before the slice opens and after
    it closes) and its counts, and the Trainer's waits before the slice."""
    rec = profiling.Recorder()
    rec.record("serve.warmup", at(-9500), at(-7000))
    for name, n, us in [("vae.decoded_rows", 4, -8000), ("serve.images", 4, -7500),  # the warm-up's
                        ("vae.decoded_rows", 4, -6000), ("vae.decoded_rows", 4, -5000), ("vae.decoded_rows", 4, -4000),
                        ("vae.decoded_rows", 4, -3000), ("serve.images", 5, -2500)]:
        rec._entries.append(profiling.Entry(name, profiling.COUNT, 9, at(us), at(us), 1, {"n": n}))
    worker = [("serve.collect", 0, 2400), ("serve.enqueue", 2400, 2600), ("serve.collect", 2600, 5500),
              ("serve.decode", 5500, 6500), ("serve.readback", 6500, 10200), ("serve.resolve", 10200, 10400),
              ("serve.collect", 10400, 12000)]
    for name, s, e in worker:
        rec.record(name, at(s), at(e), id=1)
    for name, n, us in [("vae.decoded_rows", 4, 5600), ("vae.decoded_rows", 4, 6400), ("serve.images", 3, 10300),
                        ("vae.decoded_rows", 4, 12500)]:  # the last one after the slice
        rec._entries.append(profiling.Entry(name, profiling.COUNT, 9, at(us), at(us), 1, {"n": n}))
    for s, e in [(-10000, -9000), (-5000, -3500), (-2000, -1500), (-500, 1000)]:  # µs from the slice's open
        rec.record("train.loader_wait", T_OPEN + s * 1e-6, T_OPEN + e * 1e-6)
    return rec


# Idle 1000–3000, 5000–7000, 10000–11000. Collect covers 1000–2400, 2600–3000,
# 5000–5500 and 10400–11000 of it (2900 µs); the worker's other spans 2400–2600,
# 5500–7000 and 10000–10400 (2100 µs). serve.decode (5500–6500) launched k_b
# (3000 of 5000 busy µs). The window between the warm-up and the slice decoded
# 16 rows for 5 images (the slice's 8 rows for 3 are not counted). The Trainer
# waited 500 + 500 + 500 µs of the 4000 before the slice.
READINGS = {
    "idle_collect.serve": 29.0,
    "idle_host.serve": 21.0,
    "decode_share.serve": 60.0,
    "decode_useful.serve": 31.25,
    "loader_wait_share.train": 37.5,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_reader_returns_its_exact_value(name, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", hand_recorder().recorded)
    obs = {"trace": hand_trace(), "window_s": 0.004}
    assert read_metric(name, obs) == pytest.approx(READINGS[name], abs=1e-6)


def test_the_servers_idle_readers_add_up_to_the_devices_idle(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", hand_recorder().recorded)
    obs = {"trace": hand_trace()}
    parts = read_metric("idle_collect.serve", obs) + read_metric("idle_host.serve", obs)
    assert parts == pytest.approx(read_metric("device_idle.serve", obs), abs=1e-6) == pytest.approx(50.0)


@pytest.mark.parametrize("name", sorted(READINGS))
@pytest.mark.parametrize("program", ["records-nothing", "has-no-recorder"])
def test_a_reader_is_silent_without_the_programs_entries(name, program, monkeypatch):
    if program == "records-nothing":
        monkeypatch.setattr(profiling, "recorded", profiling.Recorder().recorded)
    else:
        monkeypatch.delattr(profiling, "recorded")
    assert read_metric(name, {"trace": hand_trace(), "window_s": 0.004}) is None
    assert read_metric(name, {}) is None

