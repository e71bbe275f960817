"""The device's idle time in the traced slice while the server's worker
was busy with a batch (the program's ``serve.noise``, ``serve.enqueue``,
``serve.decode``, ``serve.readback`` and ``serve.resolve`` spans, mapped
onto the trace's clock), over the slice's span, in percent. With
``serve.collect`` these spans cover the worker's time, so this metric and
``idle_collect.serve`` add up to ``device_idle.serve``. Silent where the
program records no such span."""

import importlib.util
from pathlib import Path

SPANS = ("serve.noise", "serve.enqueue", "serve.decode", "serve.readback", "serve.resolve")


def read(obs):
    spec = importlib.util.spec_from_file_location("bench_torch.metrics.idle_collect_serve",
                                                  Path(__file__).with_name("idle_collect.serve.py"))
    collect = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(collect)
    return collect.read_idle(obs, SPANS)
