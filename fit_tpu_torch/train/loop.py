"""The training orchestrator: epochs, validation, checkpoint and resume,
metrics.

Counterpart of ``fit_tpu/train/loop.py`` for one process on one card (or
on the CPU when asked): the same loader, prefetch, logging, validation and
checkpoint-resume semantics. Every random draw comes from a generator that
the checkpoint carries: the training stream (timesteps, noise, label
dropout) and the stochastic-rounding stream on the device, and the
importance sampler's numpy stream on the host, so a resumed run replays
neither data nor noise.

Not run here, and raised on: tensor, sequence, pipeline and expert
parallelism (tp, sp, pp, ep > 1), fsdp, and the MoE FFN. The blocks' FFN
is SwiGLU or (``ffn="mlp"``) the tanh-GELU MLP. ``scan_blocks`` only
changes a ``fit_tpu`` checkpoint's layout and is accepted. On the card ``attn_backend`` must be "auto" or "fused"
(the CUDA kernels); nothing routes to the plain attention there.

Each step leaves the recorder's ``train.loader_wait`` span on the loop's
thread (``fit_tpu_torch.utils.profiling``): blocked on the loader's next
host batch. Every ``log_every`` line carries ``loader_wait_share``, the
share of the time since the last line spent in it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from fit_tpu_torch.data.dataset import LatentFolderDataset, LatentLoader
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.diffusion.timestep_samplers import create_named_schedule_sampler
from fit_tpu_torch.models.fit import create_fit
from fit_tpu_torch.sampling import mask_lengths
from fit_tpu_torch.train.state import create_train_state, make_optimizer
from fit_tpu_torch.train.step import make_eval_step, make_train_step, split_for_accumulation
from fit_tpu_torch.utils import profiling
from fit_tpu_torch.utils.checkpoint import CheckpointManager
from fit_tpu_torch.utils.config import TrainConfig
from fit_tpu_torch.utils.device import resolve_device
from fit_tpu_torch.utils.logging import MetricLogger

__all__ = ["Trainer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
_SR_SEED = 0x0ADA  # the stochastic-rounding stream's offset from global_seed


def _check_supported(cfg: TrainConfig, device: torch.device) -> None:
    queued = [f"{k}={getattr(cfg, k)}" for k in ("tp", "sp", "pp", "ep") if getattr(cfg, k) > 1]
    if cfg.fsdp:
        queued.append("fsdp")
    if queued:
        raise NotImplementedError(
            f"the port's Trainer runs one card; not ported: {', '.join(queued)} (ROADMAP Queue 1, item 10)"
        )
    if cfg.ffn == "moe":
        raise NotImplementedError("ffn='moe' is not ported (ROADMAP Queue 1, item 9)")
    if cfg.ffn not in ("swiglu", "mlp"):
        raise ValueError(f"unknown ffn {cfg.ffn!r}: use 'swiglu' or 'mlp'")
    if cfg.packing not in ("pad", "bucket"):
        raise ValueError(f"unknown packing {cfg.packing!r}: use 'pad' or 'bucket'")
    if device.type == "cuda" and cfg.attn_backend not in ("auto", "fused"):
        raise ValueError(
            f"attn_backend {cfg.attn_backend!r}: on the card attention runs through the CUDA kernels ('auto' or 'fused')"
        )


def loader_wait_s(t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` (``time.perf_counter()``) in which this
    thread waited for the loader's next host batch: its ``train.loader_wait``
    spans, clipped."""
    tid = threading.get_native_id()
    return sum(min(e.t1, t1) - max(e.t0, t0) for e in profiling.recorded(t0, t1)
               if e.name == "train.loader_wait" and e.tid == tid)


class Trainer:
    """Trains ``cfg.model`` on the latents under ``cfg.feature_path``, on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, config: TrainConfig, device="cuda"):
        self.cfg = cfg = config
        self.device = resolve_device(device)
        _check_supported(cfg, self.device)
        dtype = _DTYPES[cfg.compute_dtype]
        remat = cfg.remat if cfg.remat is not None else cfg.packing == "pad"
        self.model = create_fit(
            cfg.model, num_classes=cfg.num_classes, in_channels=cfg.channels, dtype=dtype, remat=remat,
            ffn=cfg.ffn, device=self.device, generator=torch.Generator(self.device).manual_seed(cfg.global_seed),
        )
        self.head_dim = self.model.head_dim
        self.diffusion = create_diffusion(None)  # the 1000-step training process
        self._state_dtype = _DTYPES[cfg.optimizer_state_dtype]
        # the device streams: timesteps, noise and label dropout; stochastic rounding
        self.generator = torch.Generator(self.device).manual_seed(cfg.global_seed)
        self.sr_generator = torch.Generator(self.device).manual_seed(cfg.global_seed + _SR_SEED)
        self.optimizer = make_optimizer(
            self.model.parameters(), cfg.learning_rate, cfg.weight_decay,
            moment_dtype=self._state_dtype, generator=self.sr_generator,
        )

        self.dataset = LatentFolderDataset(
            cfg.feature_path, patch_size=cfg.patch_size, sample_size=cfg.image_size,
            vae_scale=cfg.vae_scale, channels=cfg.channels, head_dim=self.head_dim,
        )
        self.loader = LatentLoader(
            self.dataset, cfg.global_batch_size, mode=cfg.packing, seed=cfg.global_seed,
            shard_id=0, num_shards=1, buckets=cfg.token_buckets,  # one host until parallel (ROADMAP Queue 1 item 10)
        )
        self.val_loader = None
        if cfg.feature_val_path and os.path.isdir(cfg.feature_val_path):
            val_ds = LatentFolderDataset(
                cfg.feature_val_path, patch_size=cfg.patch_size, sample_size=cfg.image_size,
                vae_scale=cfg.vae_scale, channels=cfg.channels, head_dim=self.head_dim, hflip=False,
            )
            self.val_loader = LatentLoader(val_ds, cfg.global_batch_size, mode="pad", shuffle=False, seed=cfg.global_seed,
                                           shard_id=0, num_shards=1)

        self.t_sampler = create_named_schedule_sampler(cfg.timestep_sampler, self.diffusion.original_num_steps)
        self._use_t_sampler = cfg.timestep_sampler != "uniform"
        self._t_rng = np.random.default_rng(cfg.global_seed * 9973 + 17)

        self.train_step = make_train_step(
            self.diffusion, ema_decay=cfg.ema_decay, grad_accum=cfg.grad_accum, sr_generator=self.sr_generator
        )
        self.eval_step = make_eval_step(self.diffusion)
        self.ckpt = CheckpointManager(os.path.join(cfg.results_dir, "checkpoints"))
        os.makedirs(cfg.results_dir, exist_ok=True)
        with open(os.path.join(cfg.results_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)
        self.logger = MetricLogger(
            cfg.results_dir, run_name=cfg.model.replace("/", "-"), use_wandb=cfg.use_wandb,
            wandb_run_id=cfg.wandb_run_id,
        )
        self.start_epoch = 0
        self.start_batch = 0  # mid-epoch resume position (loader batches consumed)
        self.state = None

    def _host_state(self, epoch: int, batch_index: int) -> dict:
        return {
            "epoch": epoch,
            "batch_index": batch_index,
            "generators": {
                "train": self.generator.get_state().tolist(),
                "stochastic_round": self.sr_generator.get_state().tolist(),
                "timestep_sampler": self._t_rng.bit_generator.state,
            },
            "state_dtype": self.cfg.optimizer_state_dtype,
        }

    def _init_state(self):
        state = create_train_state(self.model, self.optimizer, ema_dtype=self._state_dtype)
        if self.cfg.resume_from_checkpoint == "none":
            return state
        restored, host_state = self.ckpt.restore(state=state)
        if restored is None:
            return state
        if host_state:
            saved = _DTYPES[host_state.get("state_dtype", "float32")]
            if saved != self._state_dtype:
                raise ValueError(
                    f"the checkpoint's optimizer state is {saved}, the config asks for {self._state_dtype}"
                )
            self.start_epoch = int(host_state.get("epoch", 0))
            self.start_batch = int(host_state.get("batch_index", 0))
            gens = host_state.get("generators", {})
            if "train" in gens:
                self.generator.set_state(torch.tensor(gens["train"], dtype=torch.uint8))
            if "stochastic_round" in gens:
                self.sr_generator.set_state(torch.tensor(gens["stochastic_round"], dtype=torch.uint8))
            if "timestep_sampler" in gens:
                self._t_rng.bit_generator.state = gens["timestep_sampler"]
        print(f"[fit_tpu_torch] resumed at step {restored.step}, epoch {self.start_epoch}, batch {self.start_batch}")
        return restored

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _device_batch(self, batch: dict, grad_accum: Optional[int] = None, train: bool = True) -> Dict[str, torch.Tensor]:
        """The model's inputs of a host batch on the device, with the mask's
        prefix lengths (checked here, on the host) and, under importance
        sampling, the drawn timesteps and weights; split into micro-batches."""
        accum = self.cfg.grad_accum if grad_accum is None else grad_accum
        host = {k: v for k, v in batch.items() if k in ("tokens", "pos", "mask", "label")}
        host["lengths"] = mask_lengths(host["mask"])
        if train and self._use_t_sampler:
            host["t"], host["t_weight"] = self.t_sampler.sample(host["tokens"].shape[0], self._t_rng)
        dev = {k: self._to_device(v) for k, v in host.items()}
        return split_for_accumulation(dev, accum) if accum > 1 else dev

    def _device_prefetched(self, batches, depth: int = 2):
        """``(device_batch, host_batch)`` with the host-to-device copies
        enqueued ``depth`` batches ahead of the step that uses them."""
        q = collections.deque()
        for b in batches:
            q.append((self._device_batch(b), b))
            if len(q) > depth:
                yield q.popleft()
        while q:
            yield q.popleft()

    def fit(self, max_steps: Optional[int] = None):
        cfg = self.cfg
        self.state = self._init_state() if self.state is None else self.state
        state = self.state
        log_every = max(1, cfg.log_every)
        t_last = time.perf_counter()
        imgs_since = 0
        done = False
        profiler = None

        for epoch in range(self.start_epoch, cfg.epochs):
            start_batch = self.start_batch if epoch == self.start_epoch else 0
            batch_index = start_batch
            host_batches = self.loader.prefetched(epoch, num_threads=cfg.num_workers, start_batch=start_batch)
            with contextlib.closing(host_batches):
                for dev_batch, batch in self._device_prefetched(host_batches):
                    if cfg.profile_dir and state.step == 10:
                        profiler = torch.profiler.profile()
                        profiler.start()
                    state, metrics = self.train_step(state, dev_batch, self.generator)
                    if self._use_t_sampler:
                        # the loss-aware sampler's history: one host sync per step
                        self.t_sampler.update_with_local_losses(
                            metrics["t"].cpu().numpy(), metrics["t_loss"].float().cpu().numpy()
                        )
                    batch_index += 1
                    if profiler is not None and state.step == 20:
                        profiler.stop()
                        os.makedirs(cfg.profile_dir, exist_ok=True)
                        profiler.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
                        profiler = None
                    imgs_since += batch["tokens"].shape[0]
                    if state.step % log_every == 0:
                        loss = float(metrics["loss"])
                        now = time.perf_counter()
                        dt = now - t_last
                        extra = {}
                        if profiling.enabled():
                            extra["loader_wait_share"] = loader_wait_s(t_last, now) / max(dt, 1e-9)
                        self.logger.log(
                            state.step, train_loss=loss, grad_norm=float(metrics["grad_norm"]),
                            images_per_sec=imgs_since / max(dt, 1e-9), epoch=epoch, **extra,
                        )
                        t_last, imgs_since = time.perf_counter(), 0
                    if max_steps is not None and state.step >= max_steps:
                        done = True
                        break

            if self.val_loader is not None:
                val_losses = [
                    float(self.eval_step(self.model, state.ema, self._device_batch(vb, 1, train=False), self.generator))
                    for vb in self.val_loader.epoch_batches(0)
                ]
                if val_losses:
                    self.logger.log(state.step, val_loss=float(np.mean(val_losses)), epoch=epoch)

            if (epoch + 1) % cfg.ckpt_every_epochs == 0 or done:
                # the loader position and the generators ride along, so a
                # resumed run replays neither data nor noise
                ended = not done or batch_index >= len(self.loader)
                self.ckpt.save(
                    state.step, state,
                    host_state=self._host_state(epoch + 1 if ended else epoch, 0 if ended else batch_index),
                )
            if done:
                break

        if profiler is not None:
            profiler.stop()
        self.ckpt.wait()
        self.state = state
        return state
