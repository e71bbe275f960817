"""The port's evaluation (InceptionV3 features, FID, IS, Precision/Recall)
against fit_tpu's on the same weights and inputs.

The weights are ``tests/test_inception.py``'s seeded torchvision-layout
state dict (no Inception weights are in the repository), through both
packages' converters. Features are compared at 299^2 (no resize), 128^2
(upscaling) and 512^2 (downscaling, where the resize antialiases) within
1e-4 max abs; the host-side metrics are the same numpy code and must agree
to 1e-10.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.eval import fid as ref_fid
from fit_tpu.eval import inception as ref_inc
from fit_tpu.eval import metrics as ref_metrics
from fit_tpu_torch.eval import fid, inception, metrics
from test_inception import _fake_inception_sd

FEATURE_ATOL = 1e-4
METRIC_TOL = 1e-10
SIZES = [(299, 299), (128, 128), (512, 512)]



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

def _with_fc(classes: int, seed: int = 7) -> dict:
    sd = _fake_inception_sd()
    rng = np.random.default_rng(seed)
    sd["fc.weight"] = (rng.normal(size=(classes, 2048)) * 0.02).astype(np.float32)
    sd["fc.bias"] = (0.01 * rng.normal(size=(classes,))).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def nets():
    """(state dict, fit_tpu params, port module), 1008-way fc (pytorch-fid's)."""
    sd = _with_fc(1008)
    return sd, ref_inc.convert_torch_inception(sd), inception.convert_torch_inception(sd)


def _images(seed: int, side, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(n, 3, *side)).astype(np.float32)


@pytest.mark.parametrize("side", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_features_logits_and_suite_match_fit_tpu(nets, variant, side):
    """pool3, spatial and logits of the port's functions, and its one-pass
    suite extractor, against fit_tpu's suite extractor (one trunk pass; its
    logits are pool3 @ fc, as ``inception_logits`` computes them)."""
    _, params, model = nets
    x = _images(1, side)
    want = ref_inc.make_suite_extractor(params, variant=variant, spatial=True, probs=True)(x)
    want_logits = want["pool3"] @ params["fc"]["kernel"] + params["fc"]["bias"]
    pool3, spatial = inception.pool3_and_spatial_features(model, x, variant)
    logits = inception.inception_logits(model, x, variant)
    assert pool3.shape == (2, 2048) and spatial.shape == (2, 17 * 17 * 7) and logits.shape == (2, 1008)
    for got, ref in ((pool3, want["pool3"]), (spatial, want["spatial"]), (logits, want_logits)):
        np.testing.assert_allclose(got.numpy(), ref, atol=FEATURE_ATOL, rtol=0)
    np.testing.assert_array_equal(inception.pool3_features(model, x, variant).numpy(), pool3.numpy())
    suite = inception.make_suite_extractor(model, variant=variant, spatial=True, probs=True, device="cpu")(x)
    assert set(suite) == set(want) == {"pool3", "spatial", "probs"}
    for k in want:
        np.testing.assert_allclose(suite[k], want[k], atol=FEATURE_ATOL, rtol=0, err_msg=k)
    # the one-pass suite equals the single-purpose extractors, and pool3 alone is pool3 alone
    np.testing.assert_array_equal(suite["pool3"], pool3.numpy())
    np.testing.assert_array_equal(suite["spatial"], spatial.numpy())
    np.testing.assert_allclose(suite["probs"], inception.make_logits_extractor(model, variant, device="cpu")(x),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(suite["probs"].sum(1), 1.0, atol=1e-5)
    assert set(inception.make_suite_extractor(model, variant=variant, device="cpu")(x)) == {"pool3"}
    np.testing.assert_array_equal(inception.make_feature_extractor(model, variant, device="cpu")(x), suite["pool3"])


def test_fc_is_required_for_logits_and_probs():
    model = inception.convert_torch_inception(_fake_inception_sd())
    assert model.fc is None
    x = np.zeros((1, 3, 75, 75), np.float32)
    for call in (
        lambda: inception.inception_logits(model, x),
        lambda: inception.make_logits_extractor(model, device="cpu"),
        lambda: inception.make_suite_extractor(model, probs=True, device="cpu"),
    ):
        with pytest.raises(ValueError, match="fc"):
            call()
    with pytest.raises(ValueError, match="variant"):
        inception.pool3_features(model, x, variant="tf")


def test_extractors_run_on_the_card_by_default(nets):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, _, model = nets
    for make in (inception.make_feature_extractor, inception.make_logits_extractor, inception.make_suite_extractor):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(model)


def test_load_torch_inception_round_trip(tmp_path):
    """A torchvision-style .pth (tensors, 1000-way fc) loads to the module
    that converting the same state dict gives, with fit_tpu's folding:
    each convolution's weight is fit_tpu's kernel times its BatchNorm
    scale, its bias fit_tpu's folded bias."""
    sd = _with_fc(1000, seed=3)
    path = tmp_path / "inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    loaded = inception.load_torch_inception(str(path))
    direct = inception.convert_torch_inception(sd)
    assert loaded.fc.out_features == 1000
    for (k, a), (k2, b) in zip(loaded.state_dict().items(), direct.state_dict().items()):
        assert k == k2 and a.dtype == torch.float32 and torch.equal(a, b), k
    ref = ref_inc.load_torch_inception(str(path))
    for name in ("Conv2d_1a_3x3", "Mixed_6d.branch1x1", "Mixed_7c.branch3x3dbl_3b"):
        p = ref
        for part in name.split("."):
            p = p[part]
        conv = loaded.get_submodule(name)
        want_w = np.transpose(p["kernel"], (3, 2, 0, 1)) * p["scale"][:, None, None, None]
        np.testing.assert_allclose(conv.weight.detach().numpy(), want_w, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(conv.bias.detach().numpy(), p["bias"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(loaded.fc.weight.detach().numpy().T, ref["fc"]["kernel"])


def _stats(seed: int, n: int, d: int):
    f = np.random.default_rng(seed).normal(size=(n, d)) * np.linspace(0.5, 2.0, d)
    return f, ref_fid.feature_statistics(f)


@pytest.mark.parametrize("n,d", [(200, 16), (12, 40)], ids=["full_rank", "rank_deficient"])
def test_frechet_distance_matches_fit_tpu(n, d):
    fa, (mu1, c1) = _stats(0, n, d)
    fb, (mu2, c2) = _stats(1, n, d)
    for got, want in zip(fid.feature_statistics(fa), (mu1, c1)):
        np.testing.assert_array_equal(got, want)
    want = ref_fid.frechet_distance(mu1, c1, mu2, c2)
    assert np.isfinite(want)
    assert abs(fid.frechet_distance(mu1, c1, mu2, c2) - want) <= METRIC_TOL * max(1.0, abs(want))
    assert abs(fid.fid_from_features(fa, fb) - ref_fid.fid_from_features(fa, fb)) <= METRIC_TOL * max(1.0, abs(want))
    # a set against itself: 0, up to the eps jitter a singular product takes
    assert abs(fid.frechet_distance(mu1, c1, mu1, c1)) < 1e-6 * np.trace(c1)


def test_frechet_distance_without_scipy_matches_fit_tpu(monkeypatch):
    """The eigenvalue branch, taken when scipy does not import."""
    _, (mu1, c1) = _stats(2, 300, 8)
    _, (mu2, c2) = _stats(3, 300, 8)
    with_scipy = fid.frechet_distance(mu1, c1, mu2, c2)
    monkeypatch.setitem(sys.modules, "scipy", None)
    got, want = fid.frechet_distance(mu1, c1, mu2, c2), ref_fid.frechet_distance(mu1, c1, mu2, c2)
    assert got == want
    assert abs(got - with_scipy) < 1e-8 * abs(with_scipy)


def test_fid_score_matches_fit_tpu(nets):
    """Streams of images through the port's extractor (pool3's first 64
    features: scipy's sqrtm of a 2048-d product takes ~15 s here), and of
    latents flattened: both packages' fid_score give the same number."""
    _, _, model = nets
    rng = np.random.default_rng(4)
    a = [rng.uniform(size=(3, 64, 64)).astype(np.float32) for _ in range(5)]
    b = [rng.uniform(size=(3, 64, 64)).astype(np.float32) for _ in range(5)]
    port_ext = inception.make_feature_extractor(model, device="cpu")
    got = fid.fid_score(a, b, extractor=lambda x: port_ext(x)[:, :64], batch_size=3)
    assert np.isfinite(got) and got == ref_fid.fid_score(a, b, extractor=lambda x: port_ext(x)[:, :64], batch_size=3)
    lat = [rng.normal(size=(4, 8, 8)) for _ in range(7)]
    lat2 = [rng.normal(size=(4, 8, 8)) + 0.1 for _ in range(7)]
    assert fid.fid_score(lat, lat2, batch_size=3) == ref_fid.fid_score(lat, lat2, batch_size=3)


@pytest.mark.parametrize("splits", [1, 4, 10])
def test_inception_score_matches_fit_tpu(splits):
    logits = np.random.default_rng(splits).normal(size=(37, 50)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got, want = metrics.inception_score(probs, splits=splits), ref_metrics.inception_score(probs, splits=splits)
    for g, w in zip(got, want):
        assert abs(g - w) <= METRIC_TOL * max(1.0, abs(w))
    assert got[0] >= 1.0 - 1e-9


@pytest.mark.parametrize("block", [7, 4096])
def test_precision_recall_matches_fit_tpu(block):
    rng = np.random.default_rng(9)
    real = rng.normal(size=(40, 12)).astype(np.float32)
    fake = (rng.normal(size=(33, 12)) * 1.3 + 0.4).astype(np.float32)
    got = metrics.precision_recall(real, fake, k=3, block=block)
    assert got == ref_metrics.precision_recall(real, fake, k=3, block=block)
    assert got == metrics.precision_recall(real, fake, k=3, block=4096)  # blocks do not change the answer
    assert 0.0 < got[0] < 1.0 and 0.0 < got[1] <= 1.0
