"""Sample-quality metrics beyond FID: Inception Score and improved
Precision/Recall.

Counterpart of ``fit_tpu/eval/metrics.py``, numpy on the host as there.

* **Inception Score** (Salimans et al. 2016) takes class probabilities from
  the InceptionV3 ``fc`` head (``make_logits_extractor``, or the suite
  extractor's ``probs``): the checkpoint FID uses, no second network.
* **Precision/Recall** (Kynkaanniemi et al. 2019) takes the pool3 features
  FID uses, so one feature pass serves both. The k-nearest-neighbour search
  runs as blocks of pairwise distances (matrix products), not a kd-tree.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["inception_score", "precision_recall"]


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """Inception Score from (N, num_classes) class probabilities.

    IS = exp(E_x KL(p(y|x) || p(y))), per split over the samples in the
    order given (the standard protocol: 10 splits); returns (mean, std)
    over the splits.
    """
    probs = np.asarray(probs, np.float64)
    assert probs.ndim == 2, probs.shape
    n = probs.shape[0]
    splits = max(1, min(int(splits), n))
    scores = []
    for part in np.array_split(probs, splits):
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(marginal + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _kth_nn_distance(feats: np.ndarray, k: int, block: int) -> np.ndarray:
    """Distance to the k-th nearest OTHER point within ``feats`` (N,)."""
    n = feats.shape[0]
    sq = np.sum(feats**2, axis=1)
    radii = np.empty(n, feats.dtype)
    for i in range(0, n, block):
        d2 = sq[i : i + block, None] - 2.0 * (feats[i : i + block] @ feats.T) + sq[None]
        np.maximum(d2, 0.0, out=d2)
        # exclude each point itself: this block's diagonal
        rows = np.arange(i, min(i + block, n))
        d2[rows - i, rows] = np.inf
        # the k-th smallest of the other n-1 distances
        radii[i : i + block] = np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])
    return radii


def _fraction_covered(queries: np.ndarray, manifold: np.ndarray, radii: np.ndarray, block: int) -> float:
    """Fraction of ``queries`` inside any manifold point's k-NN ball."""
    m_sq = np.sum(manifold**2, axis=1)
    r2 = radii**2
    hits = 0
    for i in range(0, queries.shape[0], block):
        q = queries[i : i + block]
        d2 = np.sum(q**2, axis=1)[:, None] - 2.0 * (q @ manifold.T) + m_sq[None]
        hits += int(np.any(d2 <= r2[None], axis=1).sum())
    return hits / queries.shape[0]


def precision_recall(
    real_feats: np.ndarray,
    fake_feats: np.ndarray,
    k: int = 3,
    block: int = 4096,
) -> Tuple[float, float]:
    """Improved Precision/Recall on pool3 features.

    A set's manifold is the union of balls around its points, each with the
    radius of that point's k-th nearest neighbour in its own set. Precision
    is the fraction of FAKE samples inside the REAL manifold (realism),
    recall the fraction of REAL samples inside the FAKE manifold (coverage).
    ``k=3`` is the paper's setting.
    """
    real = np.ascontiguousarray(real_feats, np.float32)
    fake = np.ascontiguousarray(fake_feats, np.float32)
    assert real.ndim == fake.ndim == 2 and real.shape[1] == fake.shape[1]
    assert real.shape[0] > k and fake.shape[0] > k, (
        f"need more than k={k} samples per set, got "
        f"{real.shape[0]} real / {fake.shape[0]} fake"
    )
    real_radii = _kth_nn_distance(real, k, block)
    fake_radii = _kth_nn_distance(fake, k, block)
    precision = _fraction_covered(fake, real, real_radii, block)
    recall = _fraction_covered(real, fake, fake_radii, block)
    return float(precision), float(recall)
