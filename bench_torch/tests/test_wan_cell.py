"""The Wan2.1 text-to-video cell on a tiny CPU configuration: a run comes
out correct, the fp8 control comes out not correct, each planted fault of
the Wan program reaches the compared latents, and the cell's arithmetic
(FLOPs, parameters, the attention bounds and K8W's bytes) matches a direct
count."""

from __future__ import annotations

import contextlib

import pytest
import torch

from bench_torch import flops, flops_wan
from bench_torch import run as bench_run
from bench_torch.drivers import sample_wan
from bench_torch.reference import wan as ref
from bench_torch.tests.tiny import empty_slice

CELL = "wan14b_t2v_480p81_euler2_cfg"
TINY_WAN = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_len=16, text_dim=32, dtype="float32")
TRAFFIC = dict(width=96, height=64, frames=9, prompt_tokens=[4, 12])  # a (16, 3, 8, 12) latent: 72 tokens


@pytest.fixture(autouse=True)
def _few_threads_and_no_profiler(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(sample_wan, "profiled_slice", empty_slice)
    yield
    torch.set_num_threads(threads)


def tiny_run(seed, trace=False):
    run = bench_run.Run(CELL, seed, 1.0, trace, device="cpu", overrides=TRAFFIC)
    run.config["model"].update(TINY_WAN)
    return run


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(trace):
    line = bench_run.execute(tiny_run(seed=2**31 + 13, trace=trace))
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert {"setup_s", "sample_img_per_s"} <= set(line["metrics"])


def test_the_control_and_each_fault_move_the_latents():
    """The fp8 control and the planted faults change the latents by far
    more than the sound fp32 program's gap, but at this size (2 blocks, 72
    tokens, random weights) not past the limit (the control reads ~0.2,
    the limit 0.25): their readings at the cell's size, which fail it, are
    PERF.md's. The bf16 witness lies between the sound program and the fp8
    control, and the control's reading of the sound program is of the run's
    order."""
    run = tiny_run(seed=17)
    readings = sample_wan.control(run)
    assert set(readings) == {"program", "witness_bf16", "control_fp8", *sample_wan.FAULTS}
    sound = bench_run.execute(tiny_run(seed=17))["compared"]["latent_rel_err"]["value"]
    assert readings["program"]["latent_rel_err"] < 10 * sound
    assert 100 * sound < readings["witness_bf16"]["latent_rel_err"] < readings["control_fp8"]["latent_rel_err"] / 4
    assert readings["control_fp8"]["latent_rel_err"] > 1000 * sound
    for kind in sample_wan.FAULTS:
        assert readings[kind]["latent_rel_err"] > 100 * sound, (kind, readings[kind], sound)


@pytest.mark.parametrize("fault", sorted(sample_wan.FAULTS))
def test_a_planted_fault_reaches_the_checked_latents(fault, monkeypatch):
    setup = sample_wan.setup
    sound = bench_run.execute(tiny_run(seed=31))["compared"]["latent_rel_err"]["value"]
    with contextlib.ExitStack() as planted:

        def setup_then_break(run):
            state = setup(run)
            lengths = torch.tensor([5, 9])
            planted.enter_context(sample_wan.FAULTS[fault](state["model"], lengths))
            return state

        monkeypatch.setattr(sample_wan, "setup", setup_then_break)
        line = bench_run.execute(tiny_run(seed=31))
    assert line["compared"]["latent_rel_err"]["value"] > 100 * sound, (line["compared"], sound)


def test_the_faults_leave_the_model_as_it_was():
    from fit_tpu_torch.models import wan

    run = tiny_run(seed=3)
    model = sample_wan.build(run, torch.device("cpu"))
    saved = (wan.qk_norm_wide, wan.WanRMSNorm.forward, wan.WanModel.rope_tables, model.forward)
    for fault in sample_wan.FAULTS.values():
        with fault(model, torch.tensor([3, 4])):
            pass
    assert (wan.qk_norm_wide, wan.WanRMSNorm.forward, wan.WanModel.rope_tables, model.forward) == saved
    assert "forward" not in vars(model)


def test_the_flop_count_is_the_references_matmuls():
    """flops_wan's count of one forward against torch's FLOP counter over
    the plain reference's forward (matmuls only)."""
    from torch.utils.flop_counter import FlopCounterMode

    run = tiny_run(seed=5)
    m = dict(run.config["model"], patch_size=tuple(TINY_WAN.get("patch_size", (1, 2, 2))))
    w = sample_wan.outer_weights(run, "cpu")
    for prefix in sample_wan.block_prefixes(m):
        w.update(sample_wan.block_weights(run, prefix, "cpu"))
    n, (c, f, h, w_) = 2, sample_wan.latent_shape(run)
    args = (torch.randn(n, c, f, h, w_), torch.rand(n) * 1000, torch.randn(n, m["text_len"], m["text_dim"]))
    with FlopCounterMode(display=False) as counter:
        ref.forward(w, m, *args)
    assert counter.get_total_flops() == n * flops_wan.forward_flops(m, sample_wan.tokens(run), m["text_len"])


def test_the_parameter_count_is_the_registrys_and_the_drivers():
    from fit_tpu_torch.models.wan import create_wan

    m = bench_run.Run(CELL, 5, 1.0, False, device="cpu").config["model"]
    spec = sample_wan.outer_spec(m) + [s for p in sample_wan.block_prefixes(m) for s in sample_wan.block_spec(m, p)]
    count = sum(int(torch.tensor(shape).prod()) for _, shape in spec)
    assert flops_wan.param_count(m) == count == 14_288_491_584
    model = create_wan("wan2.1-t2v-14b", device="meta")
    assert count == sum(p.numel() for p in model.parameters())
    assert {n for n, _ in spec} == {n for n, _ in model.named_parameters()}


def test_the_cells_arithmetic_at_its_shapes():
    """At 832x480 and 81 frames (32,760 tokens) and 512 text rows: 1.678
    PFLOP a row-forward, ~41.9 TFLOP a block, of which self-attention's
    scores and values 21.98; the self-attention bound 40 x 44.5 ms for a
    2-row batch, the cross-attention's 40 x 0.694 ms, K8W's bytes 40 x
    4.05 GB (48.3 ms), K6G's 40 x 3.62 GB (43.3 ms)."""
    run = bench_run.Run(CELL, 5, 1.0, False, device="cpu")
    m = run.config["model"]
    t, lt = sample_wan.tokens(run), m["text_len"]
    assert sample_wan.latent_shape(run) == (16, 21, 60, 104) and t == 32_760
    assert flops_wan.forward_flops(m, t, lt) == pytest.approx(1.6784e15, rel=1e-4)
    assert flops_wan.block_flops(m, t, lt) == pytest.approx(41.94e12, rel=1e-3)
    assert flops_wan.self_attn_bound_s(m, 2, t) == pytest.approx(40 * 4 * 2 * t * t * 5120 / flops.PEAK_BF16_FLOPS)
    xw = flops_wan.cross_attn_work(m, 2, t, lt)
    assert xw == (2 * 4 * t * lt * 5120, 2 * (t * 5120 * 4 + lt * 5120 * 4 + 4))
    assert flops_wan.cross_attn_bound_s(m, 2, t, lt) == pytest.approx(40 * 0.6943e-3, rel=1e-3)
    assert flops_wan.qk_norm_bytes(m, 2, t, lt) == 40 * (2 * (3 * t + lt) * 5120 * 4 + 4 * 5120 * 2)
    assert flops_wan.qk_norm_bound_s(m, 2, t, lt) == pytest.approx(40 * 4.0465e9 / 3.35e12, rel=1e-3)
    assert flops_wan.gelu_bytes(m, 2, t) == 40 * 2 * t * 13_824 * 2 * 2
    assert flops_wan.gelu_bound_s(m, 2, t) == pytest.approx(40 * 3.6225e9 / 3.35e12, rel=1e-3)


def test_the_self_attention_share_maps_spans_through_the_clock_marks(monkeypatch):
    """The slice's range is stamped 5 ms before perf_counter() reads its
    ``t_open`` (the profiler's first range of a process), and the
    ``wan.clock`` marks carry the true offset: of two kernels, only the one
    launched inside the ``wan.self_attn`` span on the marks' clock counts,
    though the other's launch lies inside it mapped through ``t_open``. A
    mark read 30 µs late at each end does not move the mapping. Without the
    marks the metric is silent."""
    from bench_torch.run import read_metric
    from bench_torch.trace import Trace
    from fit_tpu_torch.utils import profiling

    def ev(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}

    rec = profiling.Recorder()
    rec.record("wan.self_attn", 1000.050, 1000.060)  # (55,000, 65,000) µs on the trace's clock
    monkeypatch.setattr(profiling, "recorded", rec.recorded)
    trace = Trace(t_open=1000.0, events=[
        ev("user_annotation", "bench.slice", 0, 200_000),
        ev("user_annotation", sample_wan.CLOCK, 6_000, 5),
        ev("user_annotation", sample_wan.CLOCK, 6_010, 5),
        ev("user_annotation", sample_wan.CLOCK, 106_000, 5),
        ev("user_annotation", sample_wan.CLOCK, 106_010, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 62_000, 5, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 52_000, 5, correlation=2),
        ev("kernel", "rope_attention_kernel_sm90", 63_000, 1_000, correlation=1),
        ev("kernel", "nvjet_gemm", 70_000, 3_000, correlation=2),
    ])
    assert 100 * trace.launched_within([(1000.050, 1000.060)]) / trace.busy_s == pytest.approx(75)
    obs = {"trace": trace, "clock_marks": [1000.001, 1000.001040, 1000.101030, 1000.101010]}
    assert read_metric("self_attn_share.sample", obs) == pytest.approx(25)
    assert read_metric("self_attn_share.sample", {"trace": trace}) is None
