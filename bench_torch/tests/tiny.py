"""Tiny CPU versions of the cells, for the benchmark's own tests: the
drivers' control flow at widths a CPU runs in seconds (fp32, plain kernel
versions), with a profiler slice that records nothing."""

from __future__ import annotations

import contextlib

from bench_torch import run as bench_run
from bench_torch.trace import Trace

TINY_MODEL = dict(depth=2, hidden_size=64, num_heads=4, dtype="float32")
TRAFFIC = {
    "xl_sample_ddim25_b100": dict(batch=3, steps=4, check_images=2),
    "b2_train_pad_b256": dict(latents=64, slice_steps=1),
    "b2_train_bucket_b256": dict(latents=64, slice_steps=1),
    "xl_serve_dpm20_mixed_png": dict(rate=3.0, batch_size=4, steps=3, slice_seconds=0.5),
}


@contextlib.contextmanager
def empty_slice(_torch):
    box = {}
    yield box
    box["trace"] = Trace([])


def tiny_run(cell: str, seed: int = 5, seconds: float = 1.0, trace: bool = False) -> bench_run.Run:
    run = bench_run.Run(cell, seed, seconds, trace, device="cpu", overrides=TRAFFIC[cell])
    run.config["model"].update(TINY_MODEL)
    if "vae" in run.config:
        run.config["vae"].update(block_out_channels=[32, 32], dtype="float32")
    if "train" in run.config:
        run.config["train"].update(global_batch_size=8)
    return run


@contextlib.contextmanager
def tiny_program(monkeypatch):
    """The Trainer builds its model by registry name: FiT-B/2 becomes the
    tiny widths; the profiler slice records nothing on the CPU."""
    import fit_tpu_torch.models.fit as fit_mod

    from bench_torch.drivers import sample, serve, train

    monkeypatch.setitem(fit_mod._SIZES, "B", (TINY_MODEL["depth"], TINY_MODEL["hidden_size"], TINY_MODEL["num_heads"]))
    for mod in (sample, serve, train):
        monkeypatch.setattr(mod, "profiled_slice", empty_slice)
    yield
