"""HTTP front end over :class:`fit_tpu_torch.serve.SamplingServer`.

Counterpart of ``make_handler`` in ``fit_tpu/cli/serve.py``, on the
standard library's ``http.server``:

  POST /sample   body {"label": 3, "height": 256, "width": 256, "seed": 7,
                 "deadline_s": 30}
                 -> 200, .npy bytes of the (C, h, w) float32 latent; a seed
                 reproduces the result under "ddim".
                 400 for a bad request, 429 (+ Retry-After) when the bounded
                 queue is full, 504 when deadline_s passed before dispatch,
                 500 when the batch failed.
  GET  /stats    -> JSON: served, batches, occupancy, queue depth and bound,
                 rejected and expired counts, latency percentiles
  GET  /healthz  -> 200 {"status": "ok"}

Serve a model::

    from http.server import ThreadingHTTPServer
    server = SamplingServer(model, batch_size=8, num_sampling_steps=50, device="cuda")
    ThreadingHTTPServer(("127.0.0.1", 8000), make_handler(server)).serve_forever()

The command-line entry point, which loads a checkpoint, and the PNG
responses (which need the VAE) are not ported yet.
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler

import numpy as np

from fit_tpu_torch.serve import DeadlineExceeded, ServerOverloaded

__all__ = ["make_handler"]


def make_handler(server):
    """A ``BaseHTTPRequestHandler`` class bound to ``server``."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # one line per request
            print(f"[serve] {self.address_string()} {fmt % args}")

        def _send(self, code: int, body: bytes, ctype: str, headers=()) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj, headers=()) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json", headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                self._json(200, server.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                deadline = req.get("deadline_s")
                fut = server.submit(
                    int(req.get("label", 0)),
                    int(req.get("height", 256)),
                    int(req.get("width", 256)),
                    seed=req.get("seed"),
                    deadline_s=float(deadline) if deadline is not None else None,
                )
            except ServerOverloaded as exc:
                # bounded queue full: shed load, ask for a retry after about
                # one batch latency
                self._json(429, {"error": str(exc)}, headers=[("Retry-After", "1")])
                return
            except (ValueError, KeyError, TypeError, AttributeError, json.JSONDecodeError) as exc:
                self._json(400, {"error": str(exc)})
                return
            try:
                result = fut.result()
            except DeadlineExceeded as exc:
                self._json(504, {"error": str(exc)})
                return
            except Exception as exc:  # noqa: BLE001 — a failed batch is the client's 500
                self._json(500, {"error": str(exc)})
                return
            buf = io.BytesIO()
            np.save(buf, result)
            self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler
