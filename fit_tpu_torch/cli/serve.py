"""Serving command line: an HTTP front end over
:class:`fit_tpu_torch.serve.SamplingServer`, with ``fit_tpu``'s flags,
``--vae-checkpoint`` and ``--device``.

    python -m fit_tpu_torch.cli.serve --checkpoint-path results/quantized \
        --port 8000 --serve-batch-size 8 --num-sampling-steps 50 [--sampler dpm] \
        [--torch-checkpoint last.ckpt] [--quant int8] [--vae-checkpoint vae_dir/] [--device cuda]

It loads the model as ``fit_tpu_torch.cli.sample`` does, runs one warm-up
batch (unless ``--no-warmup``), prints ``listening on http://HOST:PORT``
(``--port 0`` takes a free port) and serves until SIGINT, then stops
taking connections, serves what it accepted, prints its stats and each
kernel's launch count (warm-up included) and exits 0.

  POST /sample   body {"label": 3, "height": 256, "width": 256, "seed": 7,
                 "deadline_s": 30}
                 -> 200, .npy bytes of the (C, h, w) float32 latent, or with
                 --vae-checkpoint an image/png of height x width (decoded
                 on the card); a seed reproduces the result under "ddim"
                 and "dpm".
                 400 for a bad request, 429 (+ Retry-After) when the bounded
                 queue is full, 504 when deadline_s passed before dispatch,
                 500 when the batch failed.
  GET  /stats    -> JSON: served, batches, occupancy, queue depth and bound,
                 rejected and expired counts, latency percentiles
  GET  /healthz  -> 200 {"status": "ok"}

``--vae-checkpoint`` is a diffusers ``AutoencoderKL`` file, or a directory
holding ``sd-vae-ft-{vae}.bin`` (``--vae ema|mse``); the VAE computes in
``--dtype``. PNG bodies need PIL.
"""

from __future__ import annotations

import argparse
import io
import json
import signal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fit_tpu_torch.ops import launch_counts
from fit_tpu_torch.serve import DeadlineExceeded, SamplingServer, ServerOverloaded

__all__ = ["make_handler", "build", "main"]


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
            if result.dtype == np.uint8:  # a decoded (H, W, 3) image
                from PIL import Image

                Image.fromarray(result).save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")
            else:
                np.save(buf, result)
                self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


def build(argv=None):
    """Parse the flags, load the model, start the :class:`SamplingServer`
    (warmed up unless ``--no-warmup``) and bind the HTTP server, without
    serving yet. Returns ``(httpd, server)``."""
    from fit_tpu_torch.cli.sample import DTYPES, load_model_and_params, read_config

    parser = argparse.ArgumentParser(description="Serve a trained FiT over HTTP with fit_tpu_torch")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="serve a reference (PyTorch Lightning) FiT checkpoint")
    parser.add_argument("--quant", choices=["none", "int8"], default="none",
                        help="int8: the w8a8 path (fit_tpu_torch.ops.quant)")
    parser.add_argument("--vae-checkpoint", type=str, default=None,
                        help="a diffusers sd-vae checkpoint (file, or directory resolved by --vae): serve PNGs")
    parser.add_argument("--port", type=int, default=8000, help="0 takes a free port")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--serve-batch-size", type=int, default=8,
                        help="static batch: requests pack into exactly this many slots per dispatch")
    parser.add_argument("--max-batch-wait-s", type=float, default=0.25,
                        help="the longest the first request of a batch waits for it to fill")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="bounded request queue (default 8x batch; 0 = unbounded); full: HTTP 429")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the warm-up batch (the first request pays for it instead)")
    args, cfg = read_config(parser, argv)

    model = load_model_and_params(cfg, torch_checkpoint=args.torch_checkpoint, quant=args.quant, device=args.device)
    vae = None
    if args.vae_checkpoint:
        from fit_tpu_torch.vae import load_autoencoder

        vae = load_autoencoder(args.vae_checkpoint, cfg.vae, dtype=DTYPES[cfg.dtype], device=args.device)
        print(f"[serve] decoding with the VAE of {args.vae_checkpoint}; /sample returns PNG", flush=True)
    server = SamplingServer(
        model, batch_size=args.serve_batch_size, max_batch_wait_s=args.max_batch_wait_s,
        max_queue=args.max_queue, num_sampling_steps=cfg.num_sampling_steps, cfg_scale=cfg.cfg_scale,
        sampler=cfg.sampler, num_classes=cfg.num_classes, device=args.device, vae=vae,
    )
    try:
        if not args.no_warmup:
            print("[serve] warming up...", flush=True)
            print(f"[serve] warmup done in {server.warmup():.1f}s", flush=True)
        httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    except BaseException:
        server.close(drain=False)
        raise
    return httpd, server


def main(argv=None) -> int:
    """Build the server and serve until SIGINT; returns 0 once the accepted
    requests are served."""
    # SIGINT ends serve_forever even where the parent process ignored it
    signal.signal(signal.SIGINT, signal.default_int_handler)
    httpd, server = build(argv)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("[serve] interrupted: draining", flush=True)
    finally:
        httpd.server_close()
        server.close(drain=True)
    print(f"[serve] stopped: {json.dumps(server.stats())}", flush=True)
    print(f"[serve] kernel launches: {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
