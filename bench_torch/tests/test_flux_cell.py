"""The FLUX sampling cell and the FiT extrapolation cell on tiny CPU
configurations: a run comes out correct, the fp8 control comes out not
correct, each planted fault of the FLUX program reaches the compared
latents, and the cell's arithmetic (FLOPs, parameters, K8 and K6G bytes)
matches a direct count."""

from __future__ import annotations

import contextlib

import pytest
import torch

from bench_torch import flops_flux
from bench_torch import run as bench_run
from bench_torch.drivers import sample, sample_flux
from bench_torch.reference import flux as ref
from bench_torch.tests.tiny import TINY_MODEL, empty_slice

FLUX_CELL, NTK_CELL = "flux_schnell_sample_euler4_b4", "xl_extrapolate_ntk"
TINY_FLUX = dict(depth=1, depth_single_blocks=1, hidden_size=64, num_heads=2, axes_dim=[8, 12, 12], context_in_dim=32,
                 vec_in_dim=16, dtype="float32")
TRAFFIC = {FLUX_CELL: dict(batch=3, sizes=[[64, 96, 1.0]], txt_tokens=8, check_images=2),
           NTK_CELL: dict(batch=2, sizes=[[128, 128, 1.0]], steps=3, check_images=2)}


@pytest.fixture(autouse=True)
def _few_threads_and_no_profiler(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for mod in (sample, sample_flux):
        monkeypatch.setattr(mod, "profiled_slice", empty_slice)
    yield
    torch.set_num_threads(threads)


def tiny_run(cell, seed, trace=False):
    run = bench_run.Run(cell, seed, 1.0, trace, device="cpu", overrides=TRAFFIC[cell])
    # the extrapolation cell's tiny FiT has a 16-token budget, so a 128^2 image (64 tokens) lies past it
    run.config["model"].update(TINY_FLUX if cell == FLUX_CELL else dict(TINY_MODEL, max_length=16, max_size=8))
    return run


@pytest.mark.parametrize("cell", [FLUX_CELL, NTK_CELL])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(cell, trace):
    line = bench_run.execute(tiny_run(cell, seed=2**31 + 11, trace=trace))
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= TRAFFIC[cell]["batch"]
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert {"setup_s", "sample_img_per_s"} <= set(line["metrics"])


def test_the_control_fails_and_each_fault_moves_the_latents():
    """The fp8 control reads over the limit. The planted faults change the
    latents by far more than the sound fp32 program's gap, but at this size
    (one block of each kind, 8 text tokens, random weights) not past the
    limit: their readings at the cell's size are PERF.md's."""
    run = tiny_run(FLUX_CELL, seed=17)
    readings = sample_flux.control(run)
    assert set(readings) == {"control_fp8", *sample_flux.FAULTS}
    assert readings["control_fp8"]["latent_rel_err"] > run.limits["latent_rel_err"]
    sound = bench_run.execute(tiny_run(FLUX_CELL, seed=17))["compared"]["latent_rel_err"]["value"]
    for kind in sample_flux.FAULTS:
        assert readings[kind]["latent_rel_err"] > 1000 * sound, (kind, readings[kind], sound)


@pytest.mark.parametrize("fault", sorted(sample_flux.FAULTS))
def test_a_planted_fault_reaches_the_checked_latents(fault, monkeypatch):
    setup = sample_flux.setup
    sound = bench_run.execute(tiny_run(FLUX_CELL, seed=31))["compared"]["latent_rel_err"]["value"]
    with contextlib.ExitStack() as planted:

        def setup_then_break(run):
            state = setup(run)
            planted.enter_context(sample_flux.FAULTS[fault](state["model"]))
            return state

        monkeypatch.setattr(sample_flux, "setup", setup_then_break)
        line = bench_run.execute(tiny_run(FLUX_CELL, seed=31))
    assert line["compared"]["latent_rel_err"]["value"] > 1000 * sound, (line["compared"], sound)


def test_the_faults_leave_the_model_as_it_was():
    from fit_tpu_torch.models import flux

    run = tiny_run(FLUX_CELL, seed=3)
    model = sample_flux.build(run, torch.device("cpu"))
    saved = (flux.qk_norm, flux.QKNorm.forward, flux.Flux.rope_tables)
    for fault in sample_flux.FAULTS.values():
        with fault(model):
            pass
    assert (flux.qk_norm, flux.QKNorm.forward, flux.Flux.rope_tables) == saved


@pytest.mark.parametrize("tt,h,w", [(8, 8, 8), (4, 8, 12)])
def test_the_flop_count_is_the_references_matmuls(tt, h, w):
    """flops_flux's count of one forward against torch's FLOP counter over
    the plain reference's forward (matmuls only)."""
    from torch.utils.flop_counter import FlopCounterMode

    run = tiny_run(FLUX_CELL, seed=5)
    m = dict(run.config["model"], axes_dim=tuple(TINY_FLUX["axes_dim"]))
    w_ = sample_flux.outer_weights(run, "cpu")
    for prefix in sample_flux.block_prefixes(m):
        w_.update(sample_flux.block_weights(run, prefix, "cpu"))
    n = 3
    img, txt = torch.randn(n, (h // 2) * (w // 2), 64), torch.randn(n, tt, m["context_in_dim"])
    args = (img, ref.image_ids(n, h, w), txt, ref.text_ids(n, tt), torch.rand(n), torch.randn(n, m["vec_in_dim"]))
    with FlopCounterMode(display=False) as counter:
        ref.forward(w_, m, *args)
    assert counter.get_total_flops() == n * flops_flux.forward_flops(m, tt, (h // 2) * (w // 2))


def test_the_parameter_count_is_the_registrys_and_the_drivers():
    from fit_tpu_torch.models.flux import create_flux

    m = bench_run.Run(FLUX_CELL, 5, 1.0, False, device="cpu").config["model"]
    spec = sample_flux.outer_spec(m) + [s for p in sample_flux.block_prefixes(m) for s in sample_flux.block_spec(m, p)]
    count = sum(int(torch.tensor(shape).prod()) for _, shape in spec)
    assert flops_flux.param_count(m) == count == 11_891_178_560
    assert count == sum(p.numel() for p in create_flux("flux-schnell", device="meta").parameters())
    names = {n for n, _ in create_flux("flux-schnell", device="meta").named_parameters()}
    assert {n for n, _ in spec} == names


def test_the_cells_arithmetic_at_its_shapes():
    """At batch 4, 256 text and 4096 image tokens: 69.47 TFLOP an image
    step, both kinds of block ~280 MFLOP a token; K8 moves 28.45 GB a
    forward (8.49 ms at 3.35 TB/s) and K6G 48.77 GB (14.56 ms)."""
    m = bench_run.Run(FLUX_CELL, 5, 1.0, False, device="cpu").config["model"]
    tt, ti = 256, 4096
    assert flops_flux.forward_flops(m, tt, ti) == pytest.approx(69.4666e12, rel=1e-5)
    assert flops_flux.double_block_flops(m, tt, ti) / 4352 == pytest.approx(280.02e6, rel=1e-4)
    assert flops_flux.single_block_flops(m, 4352) / 4352 == pytest.approx(279.98e6, rel=1e-4)
    rows = 4 * (tt + ti)
    assert flops_flux.k8_bytes(m, 4, tt, ti) == 19 * (rows * 2 * 9216 * 2 + 1024) + 38 * (rows * 2 * 6144 * 2 + 512)
    assert flops_flux.gelu_bytes(m, 4, tt, ti) == 57 * rows * 2 * 12288 * 2
    assert flops_flux.k8_bound_s(m, 4, tt, ti) == pytest.approx(8.4925e-3, rel=1e-4)
    assert flops_flux.gelu_bound_s(m, 4, tt, ti) == pytest.approx(14.5586e-3, rel=1e-4)
