"""The port's FLOP counts, peak table and profiling utilities against
fit_tpu's.

``fit_forward_flops`` is the same count, so every component must be equal
for FiT-B/2, FiT-XL/2, ``ffn="mlp"`` and MoE (einsum and sort dispatch).
The peaks are the H100's; ``timeit`` and ``trace`` run here on the CPU.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from fit_tpu.utils import flops as ref_flops
from fit_tpu_torch.utils import flops, profiling

H100 = "NVIDIA H100 80GB HBM3"
CONFIGS = {
    "FiT-B/2": dict(hidden_size=768, depth=12, num_heads=12),
    "FiT-XL/2": dict(hidden_size=1152, depth=28, num_heads=16),
}


@pytest.mark.parametrize(
    "ffn_kw",
    [{}, {"ffn": "mlp"}, {"ffn": "moe", "moe_dispatch": "einsum"},
     {"ffn": "moe", "moe_dispatch": "sort", "moe_experts": 4, "moe_capacity": 2.0}],
    ids=["swiglu", "mlp", "moe_einsum", "moe_sort"],
)
@pytest.mark.parametrize("t,batch", [(256, 1), (1024, 16), (37, 3)])
@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_forward_flops_equal_fit_tpu(model, t, batch, ffn_kw):
    kw = dict(CONFIGS[model], t=t, batch=batch, **ffn_kw)
    got, want = flops.fit_forward_flops(**kw), ref_flops.fit_forward_flops(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total == pytest.approx(got.dense + got.attention + got.rope + got.cond + got.dispatch)
    assert (got.dispatch > 0) == (ffn_kw.get("ffn") == "moe")
    assert got.scaled(3.0).total == pytest.approx(3 * got.total)


def test_peaks_know_the_h100(monkeypatch):
    monkeypatch.delenv("FIT_TPU_PEAK_FLOPS", raising=False)
    assert flops.peak_flops(H100) == 989e12
    assert flops.peak_flops(H100, torch.bfloat16) == flops.peak_flops(H100, "float16") == 989e12
    assert flops.peak_flops(H100, "tf32") == 495e12
    assert flops.peak_flops(H100, torch.float32) == flops.peak_flops(H100, "float32") == 67e12
    assert flops.peak_hbm_bw(H100) == 3.35e12
    for unknown in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB", "cpu"):
        assert flops.peak_flops(unknown) is None and flops.peak_hbm_bw(unknown) is None
    with pytest.raises(ValueError, match="dtype"):
        flops.peak_flops(H100, "int8")
    if not torch.cuda.is_available():
        assert flops.peak_flops() is None and flops.peak_hbm_bw() is None  # the CPU
    monkeypatch.setenv("FIT_TPU_PEAK_FLOPS", "1.5e14")
    assert flops.peak_flops("cpu") == ref_flops.peak_flops("cpu") == 1.5e14


def test_timeit_on_the_cpu():
    calls = []

    def work(n, scale=1.0):
        calls.append(n)
        return {"out": torch.ones(n) * scale}

    stats = profiling.timeit(work, 64, iters=4, warmup=2, scale=2.0)
    assert set(stats) == {"mean_ms", "p50_ms", "min_ms", "iters"} and stats["iters"] == 4
    assert 0 <= stats["min_ms"] <= stats["p50_ms"] and stats["mean_ms"] >= stats["min_ms"]
    assert calls == [64] * 6
    profiling.force_completion({"a": [torch.zeros(2)], "b": 3})
    profiling.force_completion(None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(128, 128) @ torch.ones(128, 128)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in evt.key for evt in prof.key_averages())
