"""Frechet Inception Distance: feature statistics and the Frechet distance.

Counterpart of ``fit_tpu/eval/fid.py``, numpy and scipy on the host, as
there: the card computes the features (``fit_tpu_torch.eval.inception``),
the host their mean, covariance and distance.

FID(m1, C1, m2, C2) = |m1 - m2|^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2})

The trace term follows pytorch-fid: ``scipy.linalg.sqrtm`` of the product,
retried with eps-jittered covariances when the product is singular (2048-d
covariances of fewer than 2049 samples are rank-deficient). Without scipy it
takes ``tr((C1 C2)^{1/2}) = sum(sqrt(eig(C1 C2)))``, which holds only for
well-conditioned statistics.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np

__all__ = ["feature_statistics", "frechet_distance", "fid_from_features", "fid_score"]


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D)) in float64."""
    f = np.asarray(features, dtype=np.float64)
    assert f.ndim == 2 and f.shape[0] > 1, "need (N>1, D) features"
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray, eps: float = 1e-6
) -> float:
    """Frechet distance between two Gaussians."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.atleast_2d(cov1).astype(np.float64), np.atleast_2d(cov2).astype(np.float64)

    diff = mu1 - mu2
    try:
        from scipy import linalg as _sla
    except ImportError:  # pragma: no cover - scipy is installed where the port runs
        _sla = None

    if _sla is not None:
        # the matrix square root of the (nonsymmetric) product; a singular
        # product makes sqrtm non-finite: jitter both covariances by eps*I and
        # retry, as pytorch-fid does. scipy >= 1.17 deprecates ``disp`` and the
        # (sqrtm, errest) tuple: call it bare and take the matrix either way
        def _sqrtm(x):
            r = _sla.sqrtm(x)
            return r[0] if isinstance(r, tuple) else r

        covmean = _sqrtm(cov1 @ cov2)
        if not np.isfinite(covmean).all():
            offset = np.eye(cov1.shape[0]) * eps
            covmean = _sqrtm((cov1 + offset) @ (cov2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                m = float(np.max(np.abs(covmean.imag)))
                raise ValueError(f"sqrtm produced a significant imaginary component ({m})")
            covmean = covmean.real
        tr_sqrt = float(np.trace(covmean))
    else:
        eigvals = np.linalg.eigvals(cov1 @ cov2)
        # rounding can leave tiny negative or imaginary parts
        tr_sqrt = float(np.sqrt(np.clip(eigvals.real, 0.0, None)).sum())
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    """FID between two feature sets (N1, D) and (N2, D)."""
    mu1, cov1 = feature_statistics(feats1)
    mu2, cov2 = feature_statistics(feats2)
    return frechet_distance(mu1, cov1, mu2, cov2)


def fid_score(
    samples: Iterable[np.ndarray],
    reference: Iterable[np.ndarray],
    extractor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    batch_size: int = 64,
) -> float:
    """FID between two streams of images or latents.

    ``extractor(batch) -> (B, D)`` maps raw arrays to features (e.g.
    ``make_feature_extractor``'s pool3); without one each item is flattened
    (a FID-like distance in latent space).
    """

    def extract_all(stream):
        feats, buf = [], []
        for x in stream:
            buf.append(np.asarray(x))
            if len(buf) >= batch_size:
                feats.append(_extract(np.stack(buf), extractor))
                buf = []
        if buf:
            feats.append(_extract(np.stack(buf), extractor))
        return np.concatenate(feats, axis=0)

    return fid_from_features(extract_all(samples), extract_all(reference))


def _extract(batch: np.ndarray, extractor) -> np.ndarray:
    if extractor is None:
        return batch.reshape(batch.shape[0], -1)
    return np.asarray(extractor(batch))
