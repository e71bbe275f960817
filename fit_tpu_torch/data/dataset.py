"""Host-side latent dataset: variable-aspect VAE latents -> packed token
sequences with RoPE tables and validity masks.

Counterpart of ``fit_tpu/data/dataset.py`` on its pure-numpy path (the
native C++ packer is not ported): the same file walk, labels, flips, RoPE
tables (memoized by grid shape) and both packings, ``pad`` (every sample
zero-padded to the ``max_length`` budget) and ``bucket`` (one random token
budget per batch from a fixed set, longer samples subsampled by a random
permutation). Every batch is drawn from a per-batch seed, so a batch is the
same numpy arrays as ``fit_tpu``'s loader gives for the same seed, epoch and
index, whatever the prefetch order, and ``start_batch`` resumes mid-epoch.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fit_tpu_torch.core.geometry import patchify_np
from fit_tpu_torch.core.pos_embed import rope_freqs_2d

__all__ = [
    "LatentExample",
    "LatentFolderDataset",
    "pad_batch",
    "bucket_batch",
    "LatentLoader",
    "TOKEN_BUCKETS",
]

# masked_FiT per-batch token budgets
TOKEN_BUCKETS = (32, 64, 96, 128, 192, 256)

_LATENT_EXTS = (".npy", ".pt")


@dataclasses.dataclass
class LatentExample:
    """One packed sample before batching."""

    tokens: np.ndarray  # (T_i, p*p*C) float32
    pos: np.ndarray  # (T_i, pos_dim) float32
    label: int
    h: int  # latent height
    w: int  # latent width


def _load_latent(path: str) -> np.ndarray:
    """A (C, H, W) latent from .npy (fp16/fp32) or .pt (a torch tensor)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True).numpy().astype(np.float32)
    raise ValueError(f"unsupported latent file: {path}")


class LatentFolderDataset:
    """Walks ``root/<class_dir>/<latent files>`` and serves packed samples
    with their RoPE tables. Labels are the sorted class directory names,
    numbered densely."""

    def __init__(
        self,
        root: str,
        *,
        patch_size: int = 2,
        sample_size: int = 256,
        vae_scale: int = 8,
        channels: int = 4,
        head_dim: int = 64,
        hflip: bool = True,
    ) -> None:
        self.patch_size = patch_size
        self.vae_scale = vae_scale
        self.channels = channels
        self.head_dim = head_dim
        self.hflip = hflip
        self.max_length = (sample_size // patch_size // vae_scale) ** 2

        self.entries: List[Tuple[str, str]] = []  # (path, class_name)
        for dirpath, _, filenames in os.walk(root):
            for f in filenames:
                if os.path.splitext(f)[1].lower() in _LATENT_EXTS:
                    self.entries.append((os.path.join(dirpath, f), os.path.basename(dirpath)))
        if not self.entries:
            raise RuntimeError(f"no latent files found under `{root}`")
        self.entries.sort(key=lambda e: e[0])
        classes = sorted({c for _, c in self.entries})
        self.label_mapping: Dict[str, int] = {c: i for i, c in enumerate(classes)}
        self._pos_cache: Dict[Tuple[int, int], np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def _pos_table(self, nh: int, nw: int) -> np.ndarray:
        key = (nh, nw)
        tab = self._pos_cache.get(key)
        if tab is None:
            tab = rope_freqs_2d(self.head_dim, nh, nw).astype(np.float32)  # no VisionNTK in training
            self._pos_cache[key] = tab
        return tab

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> LatentExample:
        path, cls = self.entries[idx]
        latent = _load_latent(path)
        _, h, w = latent.shape
        if self.hflip and rng is not None and rng.random() < 0.5:
            latent = latent[..., ::-1]  # latent-domain horizontal flip
        tokens = patchify_np(np.ascontiguousarray(latent), self.patch_size)
        pos = self._pos_table(h // self.patch_size, w // self.patch_size)
        return LatentExample(tokens=tokens.astype(np.float32), pos=pos, label=self.label_mapping[cls], h=h, w=w)


def pad_batch(items: Sequence[LatentExample], max_length: int) -> Dict[str, np.ndarray]:
    """Every sample zero-padded to the fixed token budget. Returns
    ``tokens (B,T,D) / pos (B,T,P) / mask (B,T) / label (B,) / h, w (B,)``."""
    b = len(items)
    d_tok = items[0].tokens.shape[1]
    d_pos = items[0].pos.shape[1]
    tokens = np.zeros((b, max_length, d_tok), np.float32)
    pos = np.zeros((b, max_length, d_pos), np.float32)
    mask = np.zeros((b, max_length), bool)
    label = np.zeros((b,), np.int32)
    hs = np.zeros((b,), np.int32)
    ws = np.zeros((b,), np.int32)
    for i, it in enumerate(items):
        t = min(it.tokens.shape[0], max_length)
        tokens[i, :t] = it.tokens[:t]
        pos[i, :t] = it.pos[:t]
        mask[i, :t] = True
        label[i] = it.label
        hs[i] = it.h
        ws[i] = it.w
    return {"tokens": tokens, "pos": pos, "mask": mask, "label": label, "h": hs, "w": ws}


def bucket_batch(
    items: Sequence[LatentExample],
    rng: np.random.Generator,
    buckets: Sequence[int] = TOKEN_BUCKETS,
) -> Dict[str, np.ndarray]:
    """One random token budget ``n`` for the batch: longer samples keep a
    random permutation's first n tokens (pos permuted alike), shorter ones
    are padded."""
    n = int(rng.choice(buckets))
    b = len(items)
    d_tok = items[0].tokens.shape[1]
    d_pos = items[0].pos.shape[1]
    tokens = np.zeros((b, n, d_tok), np.float32)
    pos = np.zeros((b, n, d_pos), np.float32)
    mask = np.zeros((b, n), bool)
    label = np.zeros((b,), np.int32)
    for i, it in enumerate(items):
        t = it.tokens.shape[0]
        if t > n:
            perm = rng.permutation(t)[:n]
            tokens[i] = it.tokens[perm]
            pos[i] = it.pos[perm]
            mask[i] = True
        else:
            tokens[i, :t] = it.tokens
            pos[i, :t] = it.pos
            mask[i, :t] = True
        label[i] = it.label
    return {"tokens": tokens, "pos": pos, "mask": mask, "label": label}


class LatentLoader:
    """Deterministic batch iterator over an epoch permutation drawn from
    (seed, epoch); the last partial batch is dropped. ``mode`` is "pad" or
    "bucket"."""

    def __init__(
        self,
        dataset: LatentFolderDataset,
        batch_size: int,
        *,
        mode: str = "pad",
        shuffle: bool = True,
        seed: int = 0,
        buckets: Sequence[int] = TOKEN_BUCKETS,
    ) -> None:
        if mode not in ("pad", "bucket"):
            raise ValueError(f"unknown packing mode {mode!r}: use 'pad' or 'bucket'")
        self.ds = dataset
        self.batch_size = batch_size
        self.mode = mode
        self.shuffle = shuffle
        self.seed = seed
        self.buckets = buckets
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size

    def __iter__(self):
        return self.epoch_batches()

    def epoch_batches(self, epoch: Optional[int] = None, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch's batches from batch ``start_batch`` on. An explicit
        ``epoch`` leaves the internal epoch counter as it is."""
        advance = epoch is None
        epoch = self.epoch if epoch is None else epoch
        for idxs, seed in self._batch_plan(epoch)[start_batch:]:
            yield self._build_batch(idxs, seed)
        if advance:
            self.epoch = epoch + 1

    def _batch_plan(self, epoch: int):
        """The epoch's (index array, batch seed) pairs, from (seed, epoch)."""
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.ds)) if self.shuffle else np.arange(len(self.ds))
        return [
            (order[start : start + self.batch_size], (self.seed, epoch, bi))
            for bi, start in enumerate(range(0, len(self) * self.batch_size, self.batch_size))
        ]

    def _build_batch(self, idxs, batch_seed) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(batch_seed)
        items = [self.ds.__getitem__(int(i), rng=rng) for i in idxs]
        if self.mode == "pad":
            return pad_batch(items, self.ds.max_length)
        return bucket_batch(items, rng, self.buckets)

    def prefetched(
        self,
        epoch: Optional[int] = None,
        num_threads: int = 4,
        depth: int = 8,
        start_batch: int = 0,
    ):
        """The batches of :meth:`epoch_batches`, built ``depth`` ahead by
        ``num_threads`` worker threads (file reads, fp16 decode and patchify
        overlap the card's step), in plan order."""
        advance = epoch is None
        epoch = self.epoch if epoch is None else epoch
        plan = self._batch_plan(epoch)[start_batch:]
        with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
            pending = collections.deque()
            it = iter(plan)
            for _ in range(min(depth, len(plan))):
                pending.append(pool.submit(self._build_batch, *next(it)))
            while pending:
                batch = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._build_batch, *nxt))
                yield batch
        if advance:
            self.epoch = epoch + 1
