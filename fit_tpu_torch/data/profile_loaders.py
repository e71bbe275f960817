"""Data-loader benchmark: the cost of a batch for each packing generation.

Counterpart of ``fit_tpu/data/profile_loaders.py``. Three modes run through
one dataset:

* ``pad``     - every sample padded to the fixed token budget (FiT);
* ``bucket``  - one random budget a batch from the fixed bucket set
                (masked_FiT);
* ``randint`` - one budget a batch drawn uniformly from [32, max_length]
                (masked_FiT's older loader), on the numpy path with one
                random stream for the epoch.

Run: ``python -m fit_tpu_torch.data.profile_loaders --root <latents> [--batches 3000]``
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time

import numpy as np

from fit_tpu_torch.data.dataset import LatentFolderDataset, LatentLoader, bucket_batch

__all__ = ["profile_loader", "main"]


class _RandintLoader(LatentLoader):
    """The older generation: budget ~ U[32, max_length], one random stream
    an epoch."""

    def epoch_batches(self, epoch=None):
        epoch = self.epoch if epoch is None else epoch
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.ds)) if self.shuffle else np.arange(len(self.ds))
        shard = order[self.shard_id :: self.num_shards]
        limit = (len(shard) // self.batch_size) * self.batch_size
        for start in range(0, limit, self.batch_size):
            items = [self.ds.__getitem__(int(i), rng=rng) for i in shard[start : start + self.batch_size]]
            budget = int(rng.integers(32, self.ds.max_length + 1))
            yield bucket_batch(items, rng, buckets=[budget])
        self.epoch = epoch + 1


def profile_loader(loader, num_batches: int, with_cprofile: bool = False) -> dict:
    """Build ``num_batches`` batches (over as many epochs as it takes) on the
    host clock: {batches, total_s, ms_per_batch, profile (cProfile text or
    None)}."""

    def consume():
        n, epoch = 0, 0
        while n < num_batches:
            start = n
            for _ in loader.epoch_batches(epoch):
                n += 1
                if n >= num_batches:
                    break
            if n == start:
                raise ValueError("the loader gives no batch in an epoch (fewer samples a shard than batch_size?)")
            epoch += 1
        return n

    prof_text = None
    t0 = time.perf_counter()
    if with_cprofile:
        pr = cProfile.Profile()
        pr.enable()
        n = consume()
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(15)
        prof_text = s.getvalue()
    else:
        n = consume()
    dt = time.perf_counter() - t0
    return {"batches": n, "total_s": dt, "ms_per_batch": dt / max(n, 1) * 1e3, "profile": prof_text}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--batches", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--cprofile", action="store_true")
    args = ap.parse_args(argv)

    ds = LatentFolderDataset(args.root)
    loaders = {
        "pad": LatentLoader(ds, args.batch_size, mode="pad"),
        "bucket": LatentLoader(ds, args.batch_size, mode="bucket"),
        "randint": _RandintLoader(ds, args.batch_size, mode="bucket", native=False),
    }
    for name, loader in loaders.items():
        n = min(args.batches, len(loader) or 1)
        stats = profile_loader(loader, n, with_cprofile=args.cprofile)
        print(f"[{name}] {stats['batches']} batches, {stats['ms_per_batch']:.2f} ms/batch")
        if stats["profile"]:
            print(stats["profile"])


if __name__ == "__main__":
    main()
