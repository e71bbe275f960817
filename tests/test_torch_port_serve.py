"""The int8 serving slice of fit_tpu_torch against fit_tpu.

1. The int8 FiT forward of the port (plain kernels on the CPU) against
   fit_tpu's int8 forward on the same quantized weights, through both of
   fit_tpu's int8 paths: the XLA dynamic quant, and the Pallas quant
   epilogues (forced on, interpret mode). fp32 compute. Tolerance: 1e-3 of
   the output's largest magnitude. Both sides quantize the same fp32 values,
   so the int8 codes agree except where a LayerNorm or GEMM sum taken in
   another order moves a value across a rounding boundary; one such code
   moves the output by a fraction of one quantization step (1/127 of a
   row's absmax), which stays far under fit_tpu's own 5e-2 bar between its
   two int8 paths (tests/test_quant.py).
2. A seeded request through the port's SamplingServer against fit_tpu's
   FiTSampler.sample_mixed on the same weights, with the z that fit_tpu's
   server draws for that seed. DDIM, fp32, the sampler's bar: 1e-4 or
   2e-6 of the latents' largest magnitude (test_torch_port_sampling.py).
3. The behavioural contract of tests/test_serve.py, on the port: batching,
   padding, mixed sizes, determinism across batch compositions, validation,
   error propagation, close and drain, the bounded queue, deadlines, and the
   HTTP front end (200 .npy, /stats, /healthz, 400, 429, 504, 500); and the
   port's completer: a batch answered before the next batch's launch
   returns, a read-back failure failing only its batch, both threads
   stopped by close. Every wait has a timeout.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fit_tpu.ops.quant as jq
from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.models import FiT as JaxFiT
from fit_tpu.sampling import FiTSampler as JaxSampler
from fit_tpu.serve import SamplingServer as JaxServer
from fit_tpu_torch.cli.serve import make_handler
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax
from fit_tpu_torch.ops import quant
from fit_tpu_torch.serve import DeadlineExceeded, SamplingServer, ServerOverloaded

HID, HEADS, DEPTH, T, P, C = 96, 6, 2, 64, 2, 4
NUM_CLASSES = 10
WAIT = 60  # seconds any future or request may take before the test fails


def jax_model(quant_mode="none"):
    return JaxFiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=0.1, attn_backend="xla", quant=quant_mode,
    )


def port_model(quant_mode="none"):
    return FiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=0.1, quant=quant_mode,
    )


@pytest.fixture(scope="module")
def int8_models():
    """fit_tpu's int8 FiT and params, and the port's int8 FiT on the same
    quantized weights."""
    jm = jax_model()
    pos = np.broadcast_to(rope_freqs_2d(HID // HEADS, 8, 8), (2, T, HID // HEADS)).astype(np.float32)
    params = jm.init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, T, P * P * C)), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32),
        jnp.asarray(pos), jnp.ones((2, T), bool), train=True,
    )
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    params = jax.tree.unflatten(td, [0.05 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)])
    qjm, qparams = jq.quantize_model(jm, params)
    tm = port_model("int8")
    tm.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, qparams), DEPTH))
    return qjm, qparams, tm.eval()


def canvas_inputs(valid, seed=0):
    """A guided batch on a 16x16 canvas (64 tokens): conditional rows, then
    the same rows with the null class; ``valid`` tokens per conditional row."""
    rng = np.random.default_rng(seed)
    n = len(valid)
    canvas = rng.normal(size=(2 * n, C, 16, 16)).astype(np.float32)
    pos = np.zeros((2 * n, T, HID // HEADS), np.float32)
    mask = np.zeros((2 * n, T), bool)
    for i, v in enumerate(valid + valid):
        pos[i, :v] = rope_freqs_2d(HID // HEADS, 8, 8)[:v]
        mask[i, :v] = True
    t = np.full((2 * n,), rng.integers(0, 1000), np.int32)
    y = np.concatenate([rng.integers(0, NUM_CLASSES, size=(n,)), np.full((n,), NUM_CLASSES)]).astype(np.int32)
    return canvas, t, y, pos, mask


def patches(a):
    """(N, C, 16, 16) canvas -> (N, 64, 4C) tokens, to compare valid tokens."""
    return a.reshape(a.shape[0], C, 8, P, 8, P).transpose(0, 2, 4, 3, 5, 1).reshape(a.shape[0], T, -1)


@pytest.mark.parametrize("fused", [False, True], ids=["xla-quant", "pallas-epilogues"])
def test_int8_forward_matches_jax(int8_models, fused, monkeypatch):
    qjm, qparams, tm = int8_models
    valid = (64, 40)
    inputs = canvas_inputs(valid)
    if fused:
        monkeypatch.setattr(jq, "use_fused_epilogue", lambda b, t_: True)
    want = np.asarray(qjm.apply(
        qparams, *(jnp.asarray(a) for a in inputs), 1.5, method=JaxFiT.forward_with_cfg
    ))
    with torch.no_grad():
        got = tm.forward_with_cfg(*(torch.from_numpy(a) for a in inputs), 1.5).numpy()
    assert got.shape == want.shape == (4, C, 16, 16)
    got, want = patches(got), patches(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    for i, n in enumerate(valid + valid):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=1e-3 * scale, rtol=0)


def jax_canvas_noise(seed, max_size):
    """The z that fit_tpu's server draws for a seeded request."""
    fake = SimpleNamespace(model=SimpleNamespace(in_channels=C), sampler=SimpleNamespace(max_size=max_size), _nprng=None)
    return JaxServer._canvas_noise(fake, SimpleNamespace(seed=seed))


SERVER_KW = dict(num_sampling_steps=4, cfg_scale=1.5, num_classes=NUM_CLASSES, max_size=16, max_length=64)
TORCH_KW = dict(SERVER_KW, device="cpu")  # the port runs on the card unless asked


def test_served_request_matches_jax_sampler(int8_models):
    qjm, qparams, tm = int8_models
    with SamplingServer(tm, batch_size=4, max_batch_wait_s=0.05, sampler="ddim", **TORCH_KW) as srv:
        a = srv.submit(3, 96, 160, seed=42).result(timeout=WAIT)
        np.testing.assert_array_equal(srv._canvas_noise(SimpleNamespace(seed=42)), jax_canvas_noise(42, 16))
    z = jax_canvas_noise(42, 16)[None]
    want = JaxSampler(qjm, sampler="ddim", **SERVER_KW).sample_mixed(
        qparams, [3], [(96, 160)], jax.random.PRNGKey(0), z=jnp.asarray(z)
    )[0]
    want = np.asarray(want)
    assert a.shape == want.shape == (C, 12, 20) and a.dtype == np.float32
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, want, atol=max(1e-4, 2e-6 * float(np.abs(want).max())), rtol=0)


def test_sampler_keeps_int8_weights_and_fp32_scales(int8_models):
    _, _, tm = int8_models
    model = port_model("int8")
    model.load_state_dict(tm.state_dict())
    model.dtype = torch.bfloat16
    srv = SamplingServer(model, batch_size=2, **TORCH_KW)
    try:
        qkv = model.blocks[0].attn.qkv
        assert qkv.weight.dtype == torch.int8
        assert qkv.kernel_scale.dtype == torch.float32
        assert qkv.bias.dtype == torch.bfloat16
        assert model.x_embedder.weight.dtype == torch.bfloat16
        lat = srv.submit(1, 128, 128, seed=0).result(timeout=WAIT)
        assert lat.shape == (C, 16, 16) and lat.dtype == np.float32 and np.isfinite(lat).all()
    finally:
        srv.close()


# --- the behavioural contract of tests/test_serve.py -----------------------


def make_server(model, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("max_batch_wait_s", 0.2)
    kw.setdefault("sampler", "ddim")
    for k, v in TORCH_KW.items():
        kw.setdefault(k, v)
    kw["num_sampling_steps"] = 2
    return SamplingServer(model, **kw)


def stall(srv):
    """Make the server's sampler wait for the returned event before each batch."""
    gate = threading.Event()
    orig = srv.sampler.sample_mixed
    srv.sampler.sample_mixed = lambda *a, **k: (gate.wait(WAIT), orig(*a, **k))[1]
    return gate


@pytest.fixture(scope="module")
def model(int8_models):
    return int8_models[2]


def test_full_batch_single_dispatch(model):
    with make_server(model) as srv:
        futs = [srv.submit(i % NUM_CLASSES, 128, 128, seed=i) for i in range(4)]
        lats = [f.result(timeout=WAIT) for f in futs]
    assert all(lat.shape == (C, 16, 16) and np.isfinite(lat).all() for lat in lats)
    s = srv.stats()
    assert s["served"] == 4 and s["batches"] == 1 and s["occupancy"] == 1.0
    assert s["latency_p50_s"] <= s["latency_p95_s"]


def test_queued_backlog_fills_batches(model):
    """With no wait for stragglers the worker still takes every request
    already queued: a backlog of 8 goes out in full batches."""
    with make_server(model, max_batch_wait_s=0.0) as srv:
        first = srv.submit(0, 128, 128, seed=0)
        backlog = [srv.submit(i % NUM_CLASSES, 128, 128, seed=i) for i in range(1, 9)]
        for f in [first, *backlog]:
            f.result(timeout=WAIT)
    s = srv.stats()
    assert s["served"] == 9 and s["batches"] <= 4, s


def test_partial_batch_padded_and_mixed_sizes(model):
    with make_server(model, max_batch_wait_s=0.05) as srv:
        f1 = srv.submit(1, 128, 128)
        f2 = srv.submit(2, 96, 160)  # a 12x20 latent: 60 tokens of the 64
        a, b = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
    assert a.shape == (C, 16, 16) and b.shape == (C, 12, 20)
    s = srv.stats()
    assert s["served"] == 2 and s["occupancy"] == 0.5


def test_seeded_request_deterministic_across_batch_compositions(model):
    """A seeded ddim request gives the same bits whatever shares its batch,
    which also shows that packed samples do not see each other."""
    with make_server(model, max_batch_wait_s=0.05) as srv:
        a = srv.submit(3, 128, 128, seed=42).result(timeout=WAIT)
        time.sleep(0.2)  # the first batch goes out alone
        futs = [srv.submit(5, 96, 160, seed=1), srv.submit(3, 128, 128, seed=42), srv.submit(7, 128, 128, seed=9)]
        b = futs[1].result(timeout=WAIT)
        for f in futs:
            f.result(timeout=WAIT)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "args,match",
    [((99, 128, 128), "label"), ((0, 256, 256), "token"), ((0, 120, 128), "multiple"), ((0, 0, 128), "multiple")],
    ids=["label", "token-budget", "patch-multiple", "empty"],
)
def test_submit_validation(model, args, match):
    with make_server(model) as srv:
        with pytest.raises(ValueError, match=match):
            srv.submit(*args)
        assert srv.stats()["queued"] == 0


def test_batch_error_propagates_to_futures(model):
    with make_server(model) as srv:
        srv.sampler.sample_mixed = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("device exploded"))
        f = srv.submit(0, 128, 128)
        with pytest.raises(RuntimeError, match="device exploded"):
            f.result(timeout=WAIT)


def test_close_without_drain_resolves_in_flight(model):
    srv = make_server(model, max_batch_wait_s=1.0, batch_size=64, max_queue=0)
    gate = stall(srv)
    f = srv.submit(0, 128, 128)
    srv._stop.set()
    gate.set()
    srv.close(drain=False)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(0, 128, 128)
    try:  # completed, or failed at close: either way resolved
        f.result(timeout=WAIT)
    except RuntimeError:
        pass
    assert f.done()


def test_close_drain_serves_all_accepted(model):
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0)
    gate = stall(srv)
    futs = [srv.submit(i % NUM_CLASSES, 128, 128, seed=i) for i in range(7)]
    gate.set()
    closer = threading.Thread(target=srv.close)  # drain=True
    closer.start()
    try:
        for f in futs:
            assert f.result(timeout=WAIT) is not None
    finally:
        closer.join(timeout=WAIT)
    with pytest.raises(RuntimeError):
        srv.submit(0, 128, 128)
    assert srv.stats()["served"] == 7


def test_a_batch_is_answered_before_the_next_batchs_launch_returns(model):
    """Batch 2's sampling waits until batch 1's futures resolve: the
    server answers a batch without waiting for the next one's launch. In
    the order that read batch 1 back after launching batch 2, the wait
    times out instead."""
    srv = make_server(model, batch_size=2, max_batch_wait_s=1.0)
    answered = threading.Event()
    calls, waited = [], []
    orig = srv.sampler.sample_mixed

    def gated(*a, **k):
        calls.append(1)
        if len(calls) == 2:  # batch 2's launch
            waited.append(answered.wait(10))
        return orig(*a, **k)

    srv.sampler.sample_mixed = gated
    try:
        futs = [srv.submit(i % NUM_CLASSES, 128, 128, seed=i) for i in range(4)]  # two full batches
        futs[0].add_done_callback(lambda _f: answered.set())
        for f in futs:
            assert f.result(timeout=WAIT) is not None
    finally:
        srv.close()
    assert waited == [True]
    assert srv.stats()["batches"] == 2


def test_a_read_back_failure_fails_only_its_own_batch(model, monkeypatch):
    """The completer's conversion of batch 1 raises: batch 1's futures
    carry the error, batch 2 is answered, and the server goes on."""
    import fit_tpu_torch.serve as serve_mod
    from fit_tpu_torch.vae import AutoencoderKL

    torch.manual_seed(0)
    vae = AutoencoderKL(block_out_channels=(32, 32), device="cpu")
    calls = []
    orig = serve_mod.to_uint8

    def failing_first(img):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("read-back failed")
        return orig(img)

    monkeypatch.setattr(serve_mod, "to_uint8", failing_first)
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0, vae=vae)
    gate = stall(srv)
    try:
        first = srv.submit(0, 128, 128, seed=0)
        time.sleep(0.1)  # the worker takes it alone and stalls on it
        second = [srv.submit(i, 128, 128, seed=i) for i in (1, 2)]
        gate.set()
        with pytest.raises(RuntimeError, match="read-back failed"):
            first.result(timeout=WAIT)
        images = [f.result(timeout=WAIT) for f in second]
        assert all(im.dtype == np.uint8 and im.ndim == 3 for im in images)
        assert srv.submit(3, 128, 128, seed=3).result(timeout=WAIT) is not None
    finally:
        gate.set()
        srv.close()
    s = srv.stats()
    assert s["served"] == 3 and s["batches"] == 2


@pytest.mark.parametrize("drain", [True, False], ids=["drain", "no-drain"])
def test_close_stops_both_threads(model, drain):
    """``close`` returns with the worker and the completer stopped; with
    drain every accepted request was answered, without it every accepted
    request is resolved, answered or failed."""
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0)
    gate = stall(srv)
    futs = [srv.submit(i % NUM_CLASSES, 128, 128, seed=i) for i in range(5)]
    gate.set()
    srv.close(drain=drain)
    assert not srv._thread.is_alive() and not srv._completer.is_alive()
    assert all(f.done() for f in futs)
    if drain:
        assert all(f.exception() is None for f in futs)
        assert srv.stats()["served"] == 5
    else:
        assert srv.stats()["served"] == sum(f.exception() is None for f in futs)


def test_overload_bounded_queue_rejects_and_recovers(model):
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0, max_queue=4)
    gate = stall(srv)
    try:
        accepted, rejected = [], 0
        for i in range(40):
            try:
                accepted.append(srv.submit(i % NUM_CLASSES, 128, 128, seed=i))
            except ServerOverloaded:
                rejected += 1
        assert rejected > 0
        assert srv.stats()["queued"] <= srv.max_queue
        assert srv.stats()["rejected"] == rejected
        gate.set()
        for f in accepted:
            assert f.result(timeout=WAIT) is not None
    finally:
        gate.set()
        srv.close(drain=False)
    assert srv.stats()["served"] == len(accepted)


def test_request_deadline_expires_in_queue(model):
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0)
    gate = stall(srv)
    try:
        hog = srv.submit(0, 128, 128)  # the worker stalls on this one
        time.sleep(0.1)
        doomed = srv.submit(1, 128, 128, deadline_s=0.05)
        live = srv.submit(2, 128, 128)
        time.sleep(0.3)  # doomed's deadline passes while it is queued
        gate.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=WAIT)
        assert live.result(timeout=WAIT) is not None
        assert hog.result(timeout=WAIT) is not None
        assert srv.stats()["expired"] == 1
    finally:
        gate.set()
        srv.close(drain=False)


def test_expired_after_dispatch_counted(model):
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0)
    gate = stall(srv)
    try:
        slow = srv.submit(0, 128, 128, deadline_s=0.2)  # dispatched at once
        time.sleep(0.5)  # the deadline passes while the batch is stalled
        gate.set()
        assert slow.result(timeout=WAIT) is not None
        t_end = time.monotonic() + WAIT
        while srv.stats()["expired_after_dispatch"] < 1 and time.monotonic() < t_end:
            time.sleep(0.02)
        st = srv.stats()
        assert st["expired_after_dispatch"] == 1 and st["expired"] == 0 and st["served"] == 1
    finally:
        gate.set()
        srv.close(drain=False)


class Http:
    """The handler over a live ThreadingHTTPServer on a free local port."""

    def __init__(self, srv):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def post(self, body):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(f"{self.base}/sample", data=data, method="POST")
        return urllib.request.urlopen(req, timeout=WAIT)

    def get(self, path):
        with urllib.request.urlopen(f"{self.base}{path}", timeout=WAIT) as resp:
            return json.loads(resp.read())

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_http_endpoint_end_to_end(model):
    with make_server(model, max_batch_wait_s=0.05) as srv:
        http = Http(srv)
        try:
            with http.post({"label": 2, "height": 128, "width": 128, "seed": 3}) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"] == "application/octet-stream"
                lat = np.load(io.BytesIO(resp.read()))
            assert lat.shape == (C, 16, 16) and lat.dtype == np.float32 and np.isfinite(lat).all()
            np.testing.assert_array_equal(lat, srv.submit(2, 128, 128, seed=3).result(timeout=WAIT))
            assert http.get("/stats")["served"] >= 1
            assert http.get("/healthz")["status"] == "ok"
        finally:
            http.close()


@pytest.mark.parametrize(
    "body", [{"label": 99}, {"label": "x"}, b"{not json", [1, 2]], ids=["label", "not-int", "not-json", "not-object"]
)
def test_http_bad_request_is_400(model, body):
    with make_server(model) as srv:
        http = Http(srv)
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                http.post(body)
            assert ei.value.code == 400
            assert "error" in json.loads(ei.value.read())
        finally:
            http.close()


def test_http_overload_returns_429(model):
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0, max_queue=2)
    gate = stall(srv)
    http = Http(srv)
    try:
        srv.submit(0, 128, 128)  # the worker takes this one and stalls
        t_end = time.monotonic() + WAIT
        while srv._q.qsize() > 0 and time.monotonic() < t_end:
            time.sleep(0.01)
        assert srv._q.qsize() == 0, "the worker never took the first request"
        with pytest.raises(ServerOverloaded):
            for i in range(10):  # the queue holds 2
                srv.submit(i % NUM_CLASSES, 128, 128)
        with pytest.raises(urllib.error.HTTPError) as ei:
            http.post({"label": 1, "height": 128, "width": 128})
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After") is not None
    finally:
        http.close()
        gate.set()
        srv.close(drain=False)


def test_http_deadline_504_and_batch_failure_500(model):
    srv = make_server(model, batch_size=2, max_batch_wait_s=0.0)
    gate = stall(srv)
    http = Http(srv)
    try:
        srv.submit(0, 128, 128)  # the worker stalls on this one
        time.sleep(0.1)
        codes = {}

        def post(name, body):
            try:
                http.post(body).close()
                codes[name] = 200
            except urllib.error.HTTPError as exc:
                codes[name] = exc.code

        late = threading.Thread(target=post, args=("late", {"label": 1, "height": 128, "width": 128, "deadline_s": 0.05}))
        late.start()
        time.sleep(0.3)  # its deadline passes in the queue
        gate.set()
        late.join(timeout=WAIT)
        assert codes["late"] == 504
        srv.sampler.sample_mixed = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("device exploded"))
        post("failed", {"label": 2, "height": 128, "width": 128})
        assert codes["failed"] == 500
    finally:
        http.close()
        gate.set()
        srv.close(drain=False)
