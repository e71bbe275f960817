"""The port's ``cli.fid`` against ``fit_tpu.cli.fid`` on the CPU: the same
PNG trees and seeded Inception ``.pth``, the printed metrics within 1e-4
relative, each package's ``--save-stats`` file read by the other, and the
flag checks.

The cross-package FID and sFID lines take ``frechet_distance``'s branch
for a missing scipy (eigenvalues of the ~2048-d product, ~3 s each here):
scipy's ``sqrtm`` of it takes ~15 s alone and minutes under the suite's
load. The sqrtm branch is held against fit_tpu's in
``test_torch_port_eval.py``, and ``test_torch_port_cuda_paths.py`` runs it
on the card.
"""

from __future__ import annotations

import json
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fit_tpu.cli import fid as ref_cli
from fit_tpu_torch.cli import fid as port_cli
from test_torch_port_cli import sample, trained  # noqa: F401 — the module's fixture
from test_torch_port_eval import _with_fc
from test_torch_port_vae_cli import vae_dir  # noqa: F401 — the module's fixture

METRIC_RTOL = 1e-4
STATS_ATOL = 1e-4  # features of the two packages (test_torch_port_eval.py's bar)
N_IMAGES, BATCH = 6, 3



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's six workers share the CPU, and torch's and BLAS's thread
    pools at full width thrash under that load (a 2.5 s case took 90 s):
    this module runs each on two threads."""
    from threadpoolctl import threadpool_limits

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(limits=2):
            yield
    finally:
        torch.set_num_threads(saved)

def _write_pngs(root, n: int, seed: int, side: int = 48) -> None:
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size=(side, side, 3), dtype=np.uint8)).save(d / f"{i}.png")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Sample and reference PNG trees, the Inception weights (1008-way fc)
    and each package's --save-stats of the reference tree."""
    root = tmp_path_factory.mktemp("fid_cli")
    _write_pngs(root / "samples", N_IMAGES, seed=1)
    _write_pngs(root / "reference", N_IMAGES, seed=2)
    weights = root / "inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _with_fc(1008).items()}, weights)
    common = ["--inception-weights", str(weights), "--batch-size", str(BATCH)]
    stats = {"port": root / "ref_port.npz", "ref": root / "ref_ref.npz"}
    _run("port", ["--samples-dir", str(root / "reference"), "--save-stats", str(stats["port"])] + common)
    _run("ref", ["--samples-dir", str(root / "reference"), "--save-stats", str(stats["ref"])] + common)
    return root, common, stats


def _run(which: str, argv, capsys=None) -> str:
    """One package's ``main`` on ``argv`` (the port's on the CPU); its stdout
    when ``capsys`` is given."""
    if which == "port":
        port_cli.main(argv + ["--device", "cpu"])
    else:
        saved = sys.argv
        sys.argv = ["fit_tpu.cli.fid", *argv]
        try:
            ref_cli.main()
        finally:
            sys.argv = saved
    return capsys.readouterr().out if capsys is not None else ""


def _metrics(out: str) -> dict:
    found = {}
    for key, pattern in {
        "fid": r"^FID: (\S+)$", "sfid": r"^sFID: (\S+)$", "is": r"^Inception Score: (\S+) \+/- (\S+)$",
        "pr": r"^Precision: (\S+)  Recall: (\S+)$",
    }.items():
        m = re.search(pattern, out, re.M)
        if m:
            found[key] = [float(g) for g in m.groups()]
    return found


def test_save_stats_agree_and_cross(trees):
    _, _, stats = trees
    port, ref = np.load(stats["port"]), np.load(stats["ref"])
    assert set(port.files) == set(ref.files) == {"mu", "sigma", "feats", "mu_s", "sigma_s"}
    assert port["feats"].shape == (N_IMAGES, 2048) and port["mu_s"].shape == (2023,)
    for k in port.files:
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(port[k], ref[k], atol=STATS_ATOL * scale, rtol=0, err_msg=k)


def test_metrics_match_fit_tpu_across_stats_files(trees, capsys, monkeypatch):
    """The port against fit_tpu's reference statistics, fit_tpu against the
    port's: FID, sFID, IS and Precision/Recall print the same numbers."""
    root, common, stats = trees
    monkeypatch.setitem(sys.modules, "scipy", None)  # both packages' eigenvalue branch
    argv = ["--samples-dir", str(root / "samples"), "--metrics", "fid,sfid,is,pr"] + common
    port = _metrics(_run("port", argv + ["--reference", str(stats["ref"])], capsys))
    ref = _metrics(_run("ref", argv + ["--reference", str(stats["port"])], capsys))
    assert set(port) == set(ref) == {"fid", "sfid", "is", "pr"}
    for key in ref:
        for got, want in zip(port[key], ref[key]):
            assert np.isfinite(got) and abs(got - want) <= METRIC_RTOL * max(1.0, abs(want)), (key, got, want)


def test_reference_directory_gives_the_saved_stats(trees, capsys):
    """A reference directory takes the same features as its saved .npz:
    Inception Score and Precision/Recall against either are equal."""
    root, common, stats = trees
    argv = ["--samples-dir", str(root / "samples"), "--metrics", "is,pr"] + common
    from_dir = _metrics(_run("port", argv + ["--reference", str(root / "reference")], capsys))
    from_npz = _metrics(_run("port", argv + ["--reference", str(stats["port"])], capsys))
    assert from_dir == from_npz and set(from_dir) == {"is", "pr"}


@pytest.mark.parametrize("which", ["port", "ref"])
@pytest.mark.parametrize(
    "case,extra",
    [
        ("unknown_metric", ["--metrics", "fid,kid"]),
        ("no_reference", ["--metrics", "fid"]),
        ("sfid_without_spatial", ["--metrics", "sfid", "--reference", "{no_spatial}"]),
        ("pr_without_feats", ["--metrics", "pr", "--reference", "{no_feats}"]),
    ],
)
def test_flag_errors_match_fit_tpu(trees, tmp_path, capsys, which, case, extra):
    root, common, stats = trees
    ref = dict(np.load(stats["port"]))
    files = {"no_spatial": tmp_path / "no_spatial.npz", "no_feats": tmp_path / "no_feats.npz"}
    np.savez(files["no_spatial"], mu=ref["mu"], sigma=ref["sigma"], feats=ref["feats"])
    np.savez(files["no_feats"], mu=ref["mu"], sigma=ref["sigma"], mu_s=ref["mu_s"], sigma_s=ref["sigma_s"])
    argv = ["--samples-dir", str(root / "samples")] + [a.format(**files) for a in extra] + common
    with pytest.raises(SystemExit) as exc:
        _run(which, argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert {"unknown_metric": "unknown --metrics", "no_reference": "--reference is required",
            "sfid_without_spatial": "sfid needs spatial", "pr_without_feats": "pr needs raw"}[case] in err


def test_cli_runs_on_the_card_by_default(trees):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    root, common, _ = trees
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--samples-dir", str(root / "samples"), "--save-stats", str(root / "x.npz")] + common)


def test_sampled_pngs_scored_like_fit_tpu(trained, vae_dir, trees, tmp_path, capsys):
    """The slice end to end on the CPU: cli.sample writes PNGs through the
    VAE and prints its kernel launches (none on the CPU, where every
    wrapper takes its plain version); cli.fid scores them against the
    reference tree as fit_tpu.cli.fid does."""
    _, ckpt = trained
    root, common, stats = trees
    out = tmp_path / "pngs"
    sample(ckpt, out, "--sampler", "dpm", "--num-samples", "5", "--vae-checkpoint", str(vae_dir))
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1].startswith("[sample] kernel launches: ")
    launches = json.loads(printed[-1].split(": ", 1)[1])
    assert launches and set(launches.values()) == {0}
    assert len(list(out.glob("generated_image_*.png"))) == 5
    argv = ["--samples-dir", str(out), "--metrics", "is,pr", "--reference", str(root / "reference")] + common
    port, ref = _metrics(_run("port", argv, capsys)), _metrics(_run("ref", argv, capsys))
    assert set(port) == {"is", "pr"}
    for key in ref:
        for got, want in zip(port[key], ref[key]):
            assert abs(got - want) <= METRIC_RTOL * max(1.0, abs(want)), (key, got, want)
