"""The one generator of traffic: every cell's inputs from its traffic file
and the run's seed.

A traffic file is data: a batch size or an arrival rate, a mix of image
sizes with their shares, the sampler and its steps. Shares are dealt out
exactly (the largest remainders take the odd slots) and the seed only
orders them, so every seed offers the same work in another order; labels
are uniform over the classes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from bench_torch.weights import derive

Size = Tuple[int, int]


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))


def deal(mix: Sequence[Sequence[float]], n: int) -> List[Size]:
    """``n`` sizes (height, width) in pixels with the mix's shares, in the
    mix's order: ``floor(share * n)`` each, the remainder to the largest
    fractions."""
    shares = np.array([float(s[2]) for s in mix])
    shares = shares / shares.sum()
    exact = shares * n
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return [(int(s[0]), int(s[1])) for s, c in zip(mix, counts) for _ in range(c)]


def shuffled_sizes(mix, n: int, r: np.random.Generator) -> List[Size]:
    sizes = deal(mix, n)
    return [sizes[i] for i in r.permutation(n)]


def labels(r: np.random.Generator, n: int, num_classes: int) -> np.ndarray:
    return r.integers(0, num_classes, size=n)


def arrivals(rate: float, seconds: float, r: np.random.Generator) -> np.ndarray:
    """Due times of an open loop offering ``rate`` requests a second over
    ``seconds``: ``round(rate * seconds)`` exponential gaps at the
    quantiles ``(i + 1/2) / n``, scaled to sum to ``seconds`` (a fixed
    set, so the offered load is the same for every seed), in the seed's
    order; the last request is due at ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()  # the window holds exactly these n arrivals
    return np.cumsum(gaps[r.permutation(n)])
