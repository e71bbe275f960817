"""Batch-serving layer: static-shape packed batching over :class:`FiTSampler`.

Counterpart of ``fit_tpu/serve.py``:

* **One static shape.** Every dispatched batch has exactly ``batch_size``
  slots on the shared square canvas (the ``max_length`` token budget); short
  batches are padded with copies of their last request (computed,
  discarded), and mixed resolutions pack into the same canvas through
  :meth:`FiTSampler.sample_mixed` with per-sample RoPE tables and lengths.
  The card always sees the same shapes, so a row's result does not depend
  on what shares its batch.
* **Diffusion-shaped batching.** A request holds its slot for the whole
  denoising loop, so the worker collects requests until the batch fills or
  ``max_batch_wait_s`` passes since the first arrival, then dispatches.
  Occupancy (real slots / dispatched slots) is the utilization metric.
* **Answers as the card finishes.** CUDA launches are asynchronous and the
  sampler moves its inputs without waiting for the device. The worker
  enqueues a batch's sampling, its decodes and the copies of its answered
  rows to pinned host memory, records a CUDA event behind them and hands
  the batch to a completer thread; it never waits for a result and goes
  straight back to collecting. The completer waits on each batch's event
  in turn, converts and resolves its futures: a batch is answered when its
  own device work completes, while the worker enqueues the next one. On a
  CPU device the rows are computed when the worker hands them over, and
  the completer answers at once.
* **Per-request determinism.** A request may carry a ``seed``; its canvas
  noise is drawn on the host with numpy from that seed alone (the same
  ``z`` as ``fit_tpu``'s server draws), so under the deterministic samplers
  "ddim" and "dpm" a seeded request reproduces whatever shared its batch.
  "ddpm" adds per-step noise from the batch's generator, seeded by the
  batch counter.
* **Backpressure and deadlines.** A bounded queue rejects overflow
  (:class:`ServerOverloaded`, HTTP 429); a request whose deadline passes
  while queued fails with :class:`DeadlineExceeded` (HTTP 504) and never
  takes a slot; one that expires after dispatch completes and is counted.
* **Spans.** The worker's time is covered, one span at a time, by the
  recorder's ``serve.collect`` (waiting for and gathering a batch),
  ``serve.noise``, ``serve.enqueue``, ``serve.decode`` (one a decode) and
  ``serve.readback`` (enqueueing the copies, the event and the hand-off),
  each with the batch's id. The completer records ``serve.await`` (blocked
  on the batch's event) and ``serve.answer`` (conversion, futures, stats),
  and counts ``serve.images`` and ``serve.answered_ahead``: the requests it
  answered while the worker was launching a later batch. ``warmup`` leaves
  a ``serve.warmup`` span (``fit_tpu_torch.utils.profiling``).
* **Pixels.** With a ``vae`` (``fit_tpu_torch.vae.AutoencoderKL``) the
  worker decodes each batch on the card right after enqueueing its
  sampling, and futures resolve to (H, W, 3) uint8 images instead of
  latents. Each answered request decodes alone, one row a call: the card
  decodes the rows it answers and no padding, and a seeded request's
  pixels, like its latent, do not depend on what shares its batch. Any
  other row count breaks that: cuDNN picks its convolution algorithm by
  shape, and on an H100 a bf16 SD-VAE decode of 2, 4, 8 or 32 rows gave a
  336x192 row other bits at another position of its call.

A worker thread, a completer thread and two queues here, and a stdlib
HTTP front end in ``fit_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fit_tpu_torch.core.geometry import token_count
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.sampling import FiTSampler
from fit_tpu_torch.utils import profiling
from fit_tpu_torch.vae.model import to_uint8

__all__ = ["SamplingServer", "ServerOverloaded", "DeadlineExceeded"]


class ServerOverloaded(RuntimeError):
    """Raised by :meth:`SamplingServer.submit` when the bounded request
    queue is full: the backpressure signal (HTTP front end: 429)."""


class DeadlineExceeded(TimeoutError):
    """Set on a request's future when its ``deadline_s`` passed while it
    was still queued; its slot goes to a live request (HTTP front end: 504)."""


@dataclasses.dataclass
class _Request:
    label: int
    height: int
    width: int
    seed: Optional[int]
    future: Future
    t_submit: float
    deadline: Optional[float] = None  # absolute time.monotonic() cutoff
    batch: int = 0  # the id of the batch that took it


_SENTINEL = object()  # close(drain=True) marker: serve everything before it


class _Readback(NamedTuple):
    """A launched batch's answered rows on the host (pinned copies on a
    card, still being written until ``done`` fires) and the event recorded
    behind them (None on a CPU)."""

    rows: List[torch.Tensor]
    done: Optional[torch.cuda.Event]


class SamplingServer:
    """Queue + worker-thread batching front end over :class:`FiTSampler`.

    ``submit`` returns a ``concurrent.futures.Future`` that resolves to the
    (C, h, w) float32 latent of one request, as a numpy array, or with a
    ``vae`` to its decoded (H, W, 3) uint8 image. The model is moved to
    ``device`` (the card unless the caller names another) and cast once by
    the sampler; the VAE stays where it is.
    """

    def __init__(
        self,
        model: FiT,
        *,
        batch_size: int = 8,
        max_batch_wait_s: float = 0.25,
        num_sampling_steps: int = 250,
        cfg_scale: float = 1.5,
        sampler: str = "ddim",
        num_classes: int = 1000,
        max_size: int = 32,
        max_length: int = 256,
        max_queue: Optional[int] = None,
        device="cuda",
        vae=None,
    ):
        self.sampler = FiTSampler(
            model,
            num_sampling_steps=num_sampling_steps,
            cfg_scale=cfg_scale,
            sampler=sampler,
            num_classes=num_classes,
            max_size=max_size,
            max_length=max_length,
            device=device,
        )
        self.model = self.sampler.model
        self.device = self.sampler.device
        self.batch_size = int(batch_size)
        self.max_batch_wait_s = float(max_batch_wait_s)
        self.num_classes = num_classes
        # bounded admission queue: 8 batches deep by default, enough to keep
        # the card fed across arrival jitter and shallow enough that the
        # worst queueing delay stays ~8 batch latencies; 0 = unbounded
        self.max_queue = 8 * self.batch_size if max_queue is None else int(max_queue)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._stop = threading.Event()
        self._closing = threading.Event()
        self._lock = threading.Lock()
        self._served = 0
        self._rejected = 0
        self._expired = 0
        self._expired_after_dispatch = 0
        self._batches = 0
        self._slots = 0
        self._latencies: "collections.deque[float]" = collections.deque(maxlen=10_000)  # the stats window
        self._batch_counter = 0  # the worker's alone
        self._launching = 0  # id of the batch inside _launch, 0 between batches
        self._nprng = np.random.default_rng(0)
        self.vae = vae
        self._launched: "queue.Queue" = queue.Queue()  # (batch, _Readback) in batch order; None ends it
        self._thread = threading.Thread(target=self._worker, name="fit-serve-worker", daemon=True)
        self._completer = threading.Thread(target=self._complete_loop, name="fit-serve-completer", daemon=True)
        self._completer.start()
        self._thread.start()

    # -- request path ------------------------------------------------------

    def submit(
        self,
        label: int,
        height: int = 256,
        width: int = 256,
        seed: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """Enqueue one class-conditional generation; returns a Future of the
        (C, h, w) float32 latent. Validation happens here, so a bad request
        fails at once instead of failing a whole batch.

        Raises :class:`ServerOverloaded` when the bounded queue is full. A
        request whose ``deadline_s`` (seconds from now) passes while it is
        still queued gets :class:`DeadlineExceeded` on its future; a request
        already dispatched always completes.
        """
        if self._stop.is_set() or self._closing.is_set():
            raise RuntimeError("server is closed")
        if not 0 <= int(label) < self.num_classes:
            raise ValueError(f"label {label} outside [0, {self.num_classes})")
        p = self.model.patch_size
        scale = self.sampler.vae_scale
        h, w = height // scale, width // scale
        if h % p or w % p or h <= 0 or w <= 0:
            raise ValueError(f"{height}x{width} is not a multiple of {scale * p} pixels")
        if token_count(h, w, p) > self.sampler.max_length:
            raise ValueError(
                f"{height}x{width} exceeds the {self.sampler.max_length}-token canvas budget; "
                "extrapolation sizes need a dedicated FiTSampler.sample call"
            )
        now = time.monotonic()
        req = _Request(
            int(label), height, width, seed, Future(), now,
            deadline=now + float(deadline_s) if deadline_s is not None else None,
        )
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._lock:
                self._rejected += 1
            raise ServerOverloaded(f"request queue full ({self.max_queue} deep): retry later") from None
        return req.future

    # -- worker ------------------------------------------------------------

    def _worker(self) -> None:
        # torch.inference_mode is thread-local: enter it in this thread
        try:
            with torch.inference_mode():
                self._serve_loop()
        finally:
            self._launched.put(None)  # the completer answers what it holds, then exits

    def _serve_loop(self) -> None:
        # the worker only collects and enqueues: _launch hands each batch to
        # the completer, which answers it once the card is done with it.
        # serve.collect covers the loop's time outside _launch's spans.
        draining = False  # close(drain=True) sentinel seen: exit when caught up
        t_collect = time.perf_counter()  # start of the open serve.collect span
        while not self._stop.is_set() and not draining:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if first is _SENTINEL:
                break
            if self._expire(first):
                continue
            batch = [first]
            deadline = first.t_submit + self.max_batch_wait_s
            while len(batch) < self.batch_size:
                # always take requests already queued (under load the queue
                # fills while the previous batch computes, long after the
                # first request's wait has passed); wait for more only until
                # that wait is over
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                if nxt is _SENTINEL:
                    draining = True
                    break
                if not self._expire(nxt):
                    batch.append(nxt)
            self._batch_counter += 1
            bid = self._batch_counter
            for r in batch:
                r.batch = bid
            profiling.record("serve.collect", t_collect, time.perf_counter(), id=bid)
            self._launch(batch)
            t_collect = time.perf_counter()
        profiling.record("serve.collect", t_collect, time.perf_counter(), id=self._batch_counter + 1)
        # a close without drain fails every request still queued
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not _SENTINEL:
                req.future.set_exception(RuntimeError("server closed"))

    def _expire(self, req: _Request) -> bool:
        """Fail a still-queued request whose deadline has passed. Returns
        True if it expired."""
        if req.deadline is not None and time.monotonic() > req.deadline:
            with self._lock:
                self._expired += 1
            req.future.set_exception(
                DeadlineExceeded(f"deadline_s elapsed after {time.monotonic() - req.t_submit:.3f}s in queue")
            )
            return True
        return False

    def _canvas_noise(self, req: _Request) -> np.ndarray:
        rng = np.random.default_rng(req.seed) if req.seed is not None else self._nprng
        c, s = self.model.in_channels, self.sampler.max_size
        return rng.standard_normal((c, s, s), dtype=np.float32)

    def _launch(self, batch: List[_Request]) -> None:
        """Build the padded batch, enqueue its denoising, its decodes and
        the copies of its answered rows on the card, and hand it to the
        completer. Waits for no result; fails the futures on an error."""
        # pad to the static batch size with copies of the last request
        padded = batch + [batch[-1]] * (self.batch_size - len(batch))
        bid = batch[0].batch
        self._launching = bid
        try:
            with profiling.span("serve.noise", id=bid):
                labels = [r.label for r in padded]
                sizes = [(r.height, r.width) for r in padded]
                z = torch.from_numpy(np.stack([self._canvas_noise(r) for r in padded]))
                generator = torch.Generator(self.device).manual_seed(bid)
            with profiling.span("serve.enqueue", id=bid):
                latents = self.sampler.sample_mixed(labels, sizes, generator=generator, z=z)
            rows = latents[: len(batch)]
            if self.vae is not None:
                # each answered request decodes alone, enqueued behind the
                # sampling: a call of more rows gives a 336x192 row other bits
                # at another position (cuDNN's algorithm changes with the
                # shape), and at one row it decodes no padding (7.7 ms of
                # device time a 256^2 row on an H100, against 4.9 ms a row at
                # 8 rows)
                rows = []
                for lat in latents[: len(batch)]:
                    with profiling.span("serve.decode", id=bid, rows=1, images=1):
                        rows.append(self.vae.decode(lat[None])[0])
                    profiling.count("vae.decoded_rows", 1, id=bid)
            with profiling.span("serve.readback", id=bid):
                if self.device.type == "cuda":
                    # fp32 copies into pinned memory behind the batch's last
                    # kernel, and an event behind them that the completer
                    # waits on with the GIL released
                    host = [torch.empty(r.shape, dtype=torch.float32, pin_memory=True) for r in rows]
                    for h, r in zip(host, rows):
                        h.copy_(r.float(), non_blocking=True)
                    done = torch.cuda.Event(blocking=True)
                    done.record(torch.cuda.current_stream(self.device))
                else:  # computed already: nothing to copy or wait on
                    host, done = [r.float() for r in rows], None
                self._launched.put((batch, _Readback(host, done)))
        except Exception as exc:  # noqa: BLE001 — the batch's futures carry it
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
        finally:
            self._launching = 0

    def _complete_loop(self) -> None:
        """The completer thread: answer each launched batch in order until
        the worker's None."""
        while True:
            launched = self._launched.get()
            if launched is None:
                return
            self._complete(*launched)

    def _complete(self, batch: List[_Request], readback: _Readback) -> None:
        """Wait until a launched batch's rows are on the host, convert them
        and resolve its futures. An error fails this batch's futures only."""
        n = len(batch)
        bid = batch[0].batch
        try:
            with profiling.span("serve.await", id=bid):
                if readback.done is not None:
                    readback.done.synchronize()
            with profiling.span("serve.answer", id=bid):
                if self.vae is None:
                    answers = [row.numpy().copy() for row in readback.rows]
                else:  # (3, H, W) in [-1, 1] -> (H, W, 3) uint8
                    answers = [to_uint8(row) for row in readback.rows]
                now = time.monotonic()
                # answered while the worker still enqueues a later batch
                ahead = n if self._launching > bid else 0
                # a dispatched request always completes (its slot cannot be taken
                # back mid-denoise); count those that resolve past their deadline
                late = sum(1 for r in batch if r.deadline is not None and now > r.deadline)
                with self._lock:  # before the futures: an answered request is in stats()
                    self._served += n
                    self._batches += 1
                    self._slots += self.batch_size
                    self._expired_after_dispatch += late
                    self._latencies.extend(now - r.t_submit for r in batch)
                profiling.count("serve.images", n, id=bid)
                profiling.count("serve.answered_ahead", ahead, id=bid)
                for req, answer in zip(batch, answers):
                    req.future.set_result(answer)
        except Exception as exc:  # noqa: BLE001 — the batch's futures carry it
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)

    # -- ops ---------------------------------------------------------------

    def warmup(self, sizes: Sequence[Tuple[int, int]] = ((256, 256),), timeout: Optional[float] = None) -> float:
        """Run one throwaway full batch (the first launches build the CUDA
        kernels), then reset the serving stats so its latency stays out of
        them. Returns the wall seconds spent."""
        with profiling.span("serve.warmup") as s:
            futs = [self.submit(0, *sizes[i % len(sizes)], seed=0) for i in range(self.batch_size)]
            for f in futs:
                f.result(timeout=timeout)
            with self._lock:
                self._served = self._batches = self._slots = 0
                self._latencies.clear()
        return time.perf_counter() - s.t0

    def stats(self) -> dict:
        """Counts since the start (or the warm-up's reset), and the latency
        percentiles, submit to answer, of the last 10,000 requests answered."""
        with self._lock:
            lat = sorted(self._latencies)
            out = {
                "served": self._served,
                "batches": self._batches,
                "occupancy": (self._served / self._slots) if self._slots else 0.0,
                "queued": self._q.qsize(),
                "max_queue": self.max_queue,
                "rejected": self._rejected,  # ServerOverloaded submits (429s)
                "expired": self._expired,  # deadline_s passed while queued
                # dispatched requests that resolved after their deadline:
                # card time spent on answers nobody waits for
                "expired_after_dispatch": self._expired_after_dispatch,
            }
            if lat:
                out["latency_p50_s"] = lat[len(lat) // 2]
                out["latency_p95_s"] = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
            return out

    def close(self, drain: bool = True) -> None:
        """Stop the server. ``drain=True`` stops admission at once but
        serves every request already accepted before the worker exits;
        ``drain=False`` fails the queued requests (``RuntimeError("server
        closed")``) and only completes the batches already on the card. Both
        threads have exited when it returns."""
        self._closing.set()
        if drain and self._thread.is_alive():
            # FIFO marker after every accepted request; put() may wait while
            # the queue is full, and the worker frees space within a batch
            self._q.put(_SENTINEL)
        else:
            self._stop.set()
        self._thread.join(timeout=120)
        self._stop.set()
        self._completer.join(timeout=120)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
