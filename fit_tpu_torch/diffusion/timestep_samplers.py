"""Timestep importance samplers for training.

Counterpart of ``fit_tpu/diffusion/timestep_samplers.py``, as a numpy copy
(that module cannot be imported without jax): uniform sampling and
loss-second-moment importance resampling. The samplers are host-side numpy
state; ``sample()`` returns numpy timesteps and importance weights that the
train step takes as ordinary batch inputs. The port trains in one process,
so the losses of a step are the whole batch's and need no gathering.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["UniformSampler", "LossSecondMomentResampler", "create_named_schedule_sampler"]


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """"uniform" or "loss-second-moment"."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler:
    """Importance-sample timesteps to reduce loss variance; training still
    optimizes the true objective through the returned reweighting."""

    num_timesteps: int

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch_size: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """-> (timesteps (B,) int32, importance weights (B,) float32)."""
        w = self.weights()
        p = w / w.sum()
        t = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[t])
        return t.astype(np.int32), weights.astype(np.float32)

    def update_with_local_losses(self, ts: np.ndarray, losses: np.ndarray) -> None:
        """One process holds the whole batch: its losses are all the losses."""
        self.update_with_all_losses(ts, losses)

    def update_with_all_losses(self, ts: np.ndarray, losses: np.ndarray) -> None:
        raise NotImplementedError


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones(num_timesteps, np.float64)

    def weights(self) -> np.ndarray:
        return self._weights

    def update_with_all_losses(self, ts, losses) -> None:
        pass


class LossSecondMomentResampler(ScheduleSampler):
    """Sample t proportional to sqrt(E[loss_t^2]) once every t has a full
    history of ``history_per_term`` losses; uniformly before that."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._loss_counts = np.zeros(num_timesteps, np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.num_timesteps, np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1
