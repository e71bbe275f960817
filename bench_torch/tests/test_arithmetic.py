"""The yardstick's arithmetic on the CPU: FLOPs, attention work, the trace
reduction, the tail and the open-loop schedule."""

from __future__ import annotations

import numpy as np
import pytest

from bench_torch import flops, traffic, weights
from bench_torch.drivers.serve import p95_ms
from bench_torch.run import load_json
from bench_torch.trace import Trace, union_length


@pytest.mark.parametrize("config", ["fit-xl2-256-bf16", "fit-b2-256-train-bf16"])
@pytest.mark.parametrize("t", [32, 128, 242, 256])
def test_forward_flops_equal_the_programs_count(config, t):
    from fit_tpu_torch.utils.flops import fit_forward_flops

    m = load_json("configs", config)["model"]
    ours = flops.rows_forward_flops(m, [t, t])
    theirs = fit_forward_flops(m["hidden_size"], m["depth"], m["num_heads"], t, batch=2, mlp_ratio=m["mlp_ratio"],
                               patch_dim=m["patch_size"] ** 2 * m["in_channels"]).total
    assert ours == pytest.approx(theirs, rel=1e-12)


def test_attention_work_counts_valid_queries_by_valid_keys():
    lengths, h, d = [256, 100, 7], 16, 72
    pairs = sum(n * n for n in lengths)
    assert flops.k1_work(lengths, h, d)[0] == 2 * 2 * pairs * d * h
    assert flops.k2_work(lengths, h, d)[0] == 5 * 2 * pairs * d * h
    # bytes follow the valid tokens, not a padded budget
    one = flops.k1_work([100], h, d)[1]
    assert flops.k1_work([100, 100], h, d)[1] == pytest.approx(2 * one)
    assert flops.k1_work([100], h, d, with_lse=True)[1] == one + 100 * h * 4
    # the sampling cell's K1 call is bound by its bytes
    f, b = flops.k1_work([256] * 200, 16, 72)
    assert flops.bound_s((f, b)) == pytest.approx(b / flops.PEAK_HBM_BYTES)


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def synthetic_trace():
    return Trace(t_open=1000.0, events=[
        _ev("user_annotation", "bench.slice", 0, 100),
        _ev("user_annotation", "bench.vae_decode", 45, 10),
        _ev("cpu_op", "aten::mm", 1, 5),
        _ev("cpu_op", "aten::add", 50, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=3),
        _ev("kernel", "gemm_a", 10, 20, tid=7, correlation=1),
        _ev("kernel", "gemm_b", 20, 20, tid=7, correlation=2),
        _ev("kernel", "add_kernel", 60, 10, tid=7, correlation=3),
        _ev("gpu_user_annotation", "bench.vae_decode", 60, 10, tid=7),
    ])


def test_idle_share_is_one_minus_a_union_of_device_intervals():
    tr = synthetic_trace()
    assert union_length([(10, 30), (20, 40), (60, 70)]) == 40
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)  # a sum would give 50
    assert tr.idle_share() == pytest.approx(0.6)
    assert tr.kernel_s(["gemm"]) == pytest.approx(40e-6)


def test_ranges_and_gaps_follow_the_launching_host_op():
    tr = synthetic_trace()
    # host spans on perf_counter's clock, the slice opened at 1000.0 s
    assert tr.launched_within([(1000.0 + 45e-6, 1000.0 + 55e-6)]) == pytest.approx(10e-6)
    assert tr.launched_within([(1000.0, 1000.0 + 1e-6)]) == 0
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["end of the slice", "aten::add", "aten::mm"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
    assert tr.top_device_ops()[0] == ["gemm_a", pytest.approx(20e-6)]


def test_an_empty_trace_reads_nothing():
    tr = Trace([])
    assert tr.idle_share() is None and tr.idle_gaps() == [] and tr.busy_s == 0


def test_p95_is_taken_over_every_request():
    fast, slow = [0.1] * 10_000, [5.0] * 1_000
    lat = slow + fast  # a window that kept only the last 10,000 would miss the slow ones
    assert p95_ms(lat) == pytest.approx(np.percentile(np.asarray(lat) * 1e3, 95))
    assert p95_ms(lat) > 1_000
    assert p95_ms([]) == float("inf")


def test_the_open_loop_schedule_repeats_from_its_seed():
    a = traffic.arrivals(7.0, 30.0, traffic.rng(2**31 + 11, "window"))
    b = traffic.arrivals(7.0, 30.0, traffic.rng(2**31 + 11, "window"))
    c = traffic.arrivals(7.0, 30.0, traffic.rng(12, "window"))
    assert np.array_equal(a, b)
    assert len(a) == len(c) == 210
    assert not np.array_equal(a, c)
    # the same gaps in another order: every seed offers the same load
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(c, prepend=0)))
    assert a[-1] == pytest.approx(30.0) and np.all(np.diff(a) > 0)


def test_sizes_are_dealt_in_exact_shares():
    mix = load_json("traffic", "xl_dpm20_mixed_png_open")["sizes"]
    sizes = traffic.deal(mix, 200)
    assert len(sizes) == 200
    assert sizes.count((256, 256)) == 80 and sizes.count((352, 176)) == 10
    r1, r2 = traffic.rng(1, "x"), traffic.rng(1, "x")
    assert traffic.shuffled_sizes(mix, 50, r1) == traffic.shuffled_sizes(mix, 50, r2)


@pytest.mark.parametrize("seed", [0, 1, -5, 2**31 + 7, 2**70])
def test_any_whole_seed_derives_a_generator_seed(seed):
    s = weights.derive(seed, "fit")
    assert 0 <= s < 2**63 and s == weights.derive(seed, "fit") != weights.derive(seed, "vae")


def test_seeded_weights_repeat_and_no_leaf_is_zero():
    import torch

    m = dict(load_json("configs", "fit-b2-256-train-bf16")["model"], depth=1)
    a = weights.make(weights.fit_spec(m), weights.fit_init, 3, "cpu")
    b = weights.make(weights.fit_spec(m), weights.fit_init, 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(float(v.abs().max()) > 0 for v in a.values())
