"""Each driver's control flow on a tiny CPU configuration: a run comes out
correct, its control and its planted faults come out not correct, and the
measuring path refuses a machine without a card."""

from __future__ import annotations

import io
from contextlib import redirect_stdout

import pytest
import torch

from bench_torch import run as bench_run
from bench_torch.tests.tiny import tiny_program, tiny_run

CELLS = ["xl_sample_ddim25_b100", "b2_train_pad_b256", "xl_serve_dpm20_mixed_png", "b2_train_bucket_b256"]


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(cell, trace, monkeypatch):
    with tiny_program(monkeypatch):
        line = bench_run.execute(tiny_run(cell, seed=2**31 + 3, trace=trace))
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "compared"
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    run = tiny_run(cell, seed=17)
    driver = __import__(f"bench_torch.drivers.{run.workload['driver']}", fromlist=["control"])
    readings = driver.control(run)["control_fp8"]
    assert any(v > run.limits[k] for k, v in readings.items()), readings


def _fails(cell, monkeypatch, **kw):
    with tiny_program(monkeypatch):
        line = bench_run.execute(tiny_run(cell, seed=23, **kw))
    return not line["correct"]


def test_an_altered_latent_fails(monkeypatch):
    from fit_tpu_torch.sampling import FiTSampler

    sample = FiTSampler.sample

    def altered(self, *a, **k):
        out = sample(self, *a, **k)
        bump = torch.zeros_like(out)
        bump[:, :, :2] = 0.5 * out.std()
        return out + bump

    monkeypatch.setattr(FiTSampler, "sample", altered)
    assert _fails("xl_sample_ddim25_b100", monkeypatch)


@pytest.mark.parametrize("cell", ["b2_train_pad_b256", "b2_train_bucket_b256"])
def test_a_step_that_leaves_its_state_unchanged_fails(cell, monkeypatch):
    import fit_tpu_torch.train.loop as loop

    make = loop.make_train_step

    def frozen(*a, **k):
        step = make(*a, **k)

        def run(state, batch, generator):
            saved = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            state, metrics = step(state, batch, generator)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(saved[n])
            return state, metrics

        return run

    monkeypatch.setattr(loop, "make_train_step", frozen)
    assert _fails(cell, monkeypatch)


@pytest.mark.parametrize("cell", ["b2_train_pad_b256", "b2_train_bucket_b256"])
def test_half_of_the_batch_left_out_fails(cell, monkeypatch):
    import fit_tpu_torch.train.step as step_mod

    loss = step_mod.diffusion_loss

    def half(model, diffusion, batch, generator=None, **kw):
        b = batch["tokens"].shape[0] // 2
        return loss(model, diffusion, {k: v[:b] for k, v in batch.items()}, generator, **kw)

    monkeypatch.setattr(step_mod, "diffusion_loss", half)
    assert _fails(cell, monkeypatch)


def test_an_altered_image_fails(monkeypatch):
    import fit_tpu_torch.serve as serve_mod

    to_uint8 = serve_mod.to_uint8
    monkeypatch.setattr(serve_mod, "to_uint8", lambda img: 255 - to_uint8(img))
    assert _fails("xl_serve_dpm20_mixed_png", monkeypatch)


def test_half_of_a_served_batch_left_out_fails(monkeypatch):
    import fit_tpu_torch.serve as serve_mod

    from bench_torch.drivers import serve as driver

    complete = serve_mod.SamplingServer._complete
    lost = []

    def half(self, batch, latents):
        keep = (len(batch) + 1) // 2
        lost.extend(batch[keep:])  # never answered
        complete(self, batch[:keep], latents)

    setup = driver.setup

    def setup_then_break(run):
        state = setup(run)  # the warm-up batch is answered whole
        monkeypatch.setattr(serve_mod.SamplingServer, "_complete", half)
        return state

    monkeypatch.setattr(driver, "setup", setup_then_break)
    monkeypatch.setattr(driver, "_settle", lambda records, deadline: None)
    with tiny_program(monkeypatch):
        line = bench_run.execute(tiny_run("xl_serve_dpm20_mixed_png", seed=29))
    assert lost and not line["correct"] and line["failed"] > 0


def test_a_machine_without_a_card_is_refused(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""
    assert "no CUDA device" in capsys.readouterr().err


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copytree(bench_run.HERE, tmp_path / "bench_torch", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench_run.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "bench_torch.run", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
