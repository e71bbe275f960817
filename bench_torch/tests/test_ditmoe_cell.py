"""The DiT-MoE sampling cell and the mixed-size FiT sampling cell on tiny
CPU configurations: a run comes out correct, the fp8 control and each
planted fault of the DiT-MoE program come out not correct, and the cell's
FLOP count equals a direct count of the reference's matmuls."""

from __future__ import annotations

import contextlib

import pytest
import torch

from bench_torch import flops_moe
from bench_torch import run as bench_run
from bench_torch.drivers import sample, sample_dit
from bench_torch.reference import ditmoe as ref
from bench_torch.tests.tiny import TINY_MODEL, empty_slice

DIT_CELL, MIXED_CELL = "ditmoe_g2_sample_ddim25_b32", "xl_sample_mixed_b100"
TINY_MOE = dict(depth=2, hidden_size=64, num_heads=4, num_experts=4, shared_hidden=128, dtype="float32")
TRAFFIC = dict(batch=3, steps=4, check_images=2)


@pytest.fixture(autouse=True)
def _few_threads_and_no_profiler(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for mod in (sample, sample_dit):
        monkeypatch.setattr(mod, "profiled_slice", empty_slice)
    yield
    torch.set_num_threads(threads)


def tiny_run(cell, seed, trace=False):
    run = bench_run.Run(cell, seed, 1.0, trace, device="cpu", overrides=TRAFFIC)
    run.config["model"].update(TINY_MOE if cell == DIT_CELL else TINY_MODEL)
    return run


@pytest.mark.parametrize("cell", [DIT_CELL, MIXED_CELL])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(cell, trace):
    line = bench_run.execute(tiny_run(cell, seed=2**31 + 7, trace=trace))
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= TRAFFIC["batch"]
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert {"setup_s", "sample_img_per_s"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", sorted(sample_dit.FAULTS))
def test_each_planted_fault_fails(fault, monkeypatch):
    setup = sample_dit.setup
    with contextlib.ExitStack() as planted:

        def setup_then_break(run):
            state = setup(run)
            planted.enter_context(sample_dit.FAULTS[fault](state["model"]))
            return state

        monkeypatch.setattr(sample_dit, "setup", setup_then_break)
        line = bench_run.execute(tiny_run(DIT_CELL, seed=31))
    assert not line["correct"], line["compared"]


def test_the_control_reads_each_fault_and_fp8_over_the_limit():
    run = tiny_run(DIT_CELL, seed=17)
    readings = sample_dit.control(run)
    assert set(readings) == {"control_fp8", *sample_dit.FAULTS}
    limit = run.limits["latent_rel_err"]
    for kind, values in readings.items():
        assert values["latent_rel_err"] > limit, (kind, values)


def test_the_faults_leave_the_model_as_it_was():
    run = tiny_run(DIT_CELL, seed=3)
    model = sample_dit.build(run, torch.device("cpu"))
    from fit_tpu_torch.models import moe

    route, shared = moe.route, moe.SparseMoeBlock._shared
    for fault in sample_dit.FAULTS.values():
        with fault(model):
            pass
    ffn = model.blocks[0].ffn
    assert (ffn.top_k, ffn.shared_hidden, moe.route, moe.SparseMoeBlock._shared) == (2, 128, route, shared)


@pytest.mark.parametrize("tokens", [16, 64])
def test_the_flop_count_is_the_references_matmuls(tokens):
    """flops_moe's count of one forward against torch's FLOP counter over
    the plain reference's forward (matmuls only; every token goes to k
    experts, so the routed total does not depend on the routes)."""
    from torch.utils.flop_counter import FlopCounterMode

    m = dict(depth=2, hidden_size=32, num_heads=2, patch_size=2, in_channels=4, mlp_ratio=4.0, num_experts=4,
             num_experts_per_tok=2, shared_hidden=64, num_classes=10, learn_sigma=True, input_size=8)
    run = bench_run.Run(DIT_CELL, 5, 1.0, False, device="cpu")
    run.config["model"] = dict(run.config["model"], **m)
    w = {**sample_dit.outer_weights(run, "cpu")}
    for i in range(m["depth"]):
        w.update(sample_dit.block_weights(run, i, "cpu"))
    side = int(tokens**0.5) * 2
    x = torch.randn(3, 4, side, side)
    t, y = torch.tensor([1, 500, 999]), torch.tensor([0, 3, 10])
    with FlopCounterMode(display=False) as counter:
        ref.forward(w, m, x, t, y)
    assert counter.get_total_flops() == 3 * flops_moe.forward_flops(m, tokens)


def test_the_expert_gemm_bound_is_compute_bound_at_the_cells_size():
    run = bench_run.Run(DIT_CELL, 5, 1.0, False, device="cpu")
    m = run.config["model"]
    fl, nbytes = flops_moe.expert_gemm_work(m, 64 * 256)
    assert fl == 2 * 64 * 256 * 3 * 2 * 1408 * 5632  # k rows a token, three D x H products
    assert fl / 989e12 > nbytes / 3.35e12
    assert flops_moe.rows_forward_flops(m, [256] * 64) / 40 == pytest.approx(2.233e12, rel=2e-3)
