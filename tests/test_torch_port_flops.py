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


# PERF.md section 6's Bound column, by table and row, in the order of the
# timer's cases of that row: (µs, what sets it); fp32 attention on the
# 3xTF32 basis, then the FMA rate's.
OPS, BYTES = "operations", "bytes"
SECTION_6 = {
    ("bf16", "1"): [(8.0, BYTES), (938.0, OPS)],  # XL T 256, then T 4096 (12 guided rows at 1024^2)
    ("bf16", "2"): [(12.0, BYTES)],
    ("bf16", "3"): [(12.0, BYTES), (941.3, OPS)],  # XL T 256, then FLUX's joint attention (B 4, T 4352, d 128)
    ("bf16", "4"): [(17.1, BYTES)],
    ("bf16", "5"): [(14.7, BYTES)],
    ("bf16", "6"): [(32.8, BYTES)],
    ("bf16", "7"): [(88.0, OPS)],
    ("bf16", "8"): [(111.8, OPS), (186.4, OPS)],  # the dq pass, K2 whole
    ("bf16", "9"): [(149.1, OPS), (17.4, BYTES)],  # the dk/dv pass, the prologue
    ("bf16", "10"): [(78.2, OPS)],
    ("bf16", "11"): [(5.7, BYTES), (70.7, BYTES), (600.9, BYTES)],  # the last: Wan's fp32 stream, bf16 out
    ("bf16", "12"): [(22.5, BYTES), (281.7, BYTES), (330.5, BYTES)],
    ("bf16", "13"): [(18.8, BYTES)],
    ("bf16", "14"): [(4.25, BYTES)],
    ("bf16", "15"): [(11.3, BYTES), (45.2, BYTES), (141.3, BYTES), (1201.7, BYTES)],  # the last: Wan's fp32 stream
    ("bf16", "16"): [(55.2, BYTES)],
    ("bf16", "17"): [(180.3, BYTES), (127.7, BYTES)],  # K8 into the joint buffer, then in place
    ("bf16", "18"): [(240.4, BYTES), (255.4, BYTES)],  # K6G contiguous, then by row stride
    ("bf16", "19"): [(694.7, OPS)],  # the cross entry: Wan's 2 x 32,760 video rows over 512 text keys
    ("bf16", "20"): [(400.6, BYTES)],  # K8W: Wan's 65,520 rows of q, D 5120, in place
    ("fp32", "10"): [((468.5, OPS), (1153.9, OPS))],
    ("fp32", "1"): [((17.3, OPS), (42.6, OPS))],
    ("fp32", "4"): [((32.8, BYTES), (76.8, OPS))],
    ("fp32", "6"): [((77.9, OPS), (191.9, OPS)), ((48.7, BYTES), (48.7, BYTES)), ((62.3, OPS), (153.5, OPS)),
                    ((46.8, OPS), (115.2, OPS))],  # K2 whole, then the prologue, dk/dv and dq passes
    ("fp32", "5"): [((38.2, OPS), (94.1, OPS))],
    ("fp32", "7"): [((527.7, OPS), (1299.6, OPS))],
    ("fp32", "8, 9"): [((1117.1, OPS), (2751.0, OPS)), ((33.9, BYTES), (33.9, BYTES)), ((893.7, OPS), (2200.8, OPS)),
                       ((670.3, OPS), (1650.6, OPS))],
}


@pytest.mark.parametrize("table,row", list(SECTION_6), ids=[f"{t}-{r.replace(', ', '-')}" for t, r in SECTION_6])
def test_kernel_bounds_are_perf_section_6s(table, row):
    """``cli.kernel_times``'s cases of each row of PERF.md's two kernel
    tables, through ``utils/flops.py``'s bound on the H100's peaks, give the
    table's Bound column: valid queries against valid keys, the bytes of
    valid tokens."""
    from fit_tpu_torch.cli import kernel_times

    cases = [c for c in kernel_times.CASES if (c.table, c.row) == (table, row)]
    got = [tuple(c.bounds(H100).values()) for c in cases]
    want = [w if table == "fp32" and c.attention else (w,) for c, w in zip(cases, SECTION_6[(table, row)])]
    assert len(cases) == len(SECTION_6[(table, row)])
    for g, w in zip(got, want):
        assert [by for _, by in g] == [by for _, by in w]
        assert [us for us, _ in g] == pytest.approx([us for us, _ in w], abs=0.051)


def test_bound_us_takes_the_larger_side():
    assert flops.bound_us((989e12 * 1e-6, 0.0), "bfloat16", H100) == (pytest.approx(1.0), "operations")
    assert flops.bound_us((1.0, 3.35e12 * 2e-6), "bfloat16", H100) == (pytest.approx(2.0), "bytes")
    assert flops.bound_us((495e12 * 1e-6, 0.0), "3xtf32", H100)[0] == pytest.approx(3.0)
    assert flops.bound_us((67e12 * 1e-6, 0.0), "float32", H100)[0] == pytest.approx(1.0)
    with pytest.raises(ValueError, match="no peak rates"):
        flops.bound_us((1.0, 1.0), "bfloat16", "cpu")
