"""The port's loader tail against fit_tpu's: the native C++ packer (its own
copy, built under ``build/fit_tpu_torch/``), ``drop_last``, ``shard_id`` /
``num_shards`` and ``profile_loaders``.

Every batch must be byte-identical to fit_tpu's ``LatentLoader`` on the same
latents and seed, native or numpy on either side, in pad and bucket
packing, with and without flips, over two epochs.
"""

from __future__ import annotations

import numpy as np
import pytest

from fit_tpu.core.geometry import patchify_np
from fit_tpu.data import LatentFolderDataset as RefDataset
from fit_tpu.data import LatentLoader as RefLoader
from fit_tpu.data import profile_loaders as ref_profile
from fit_tpu_torch.data import native
from fit_tpu_torch.data import profile_loaders
from fit_tpu_torch.data.dataset import LatentFolderDataset, LatentLoader

SHAPES = [(4, 30, 34), (4, 22, 30), (4, 32, 32), (4, 34, 32)]  # 34 x 32: 272 tokens, past the 256 budget
BUCKETS = (96, 128, 192)  # small budgets: both the subsample and the pad branch


@pytest.fixture(scope="module")
def latent_root(tmp_path_factory):
    """14 latents (fp16 and fp32) in two classes: 14 is no multiple of the
    batch, so drop_last and the shards' remainders matter."""
    root = tmp_path_factory.mktemp("tail_latents")
    rng = np.random.default_rng(0)
    for i in range(14):
        d = root / f"c{i % 2}"
        d.mkdir(exist_ok=True)
        np.save(d / f"x{i}.npy", rng.normal(size=SHAPES[i % 4]).astype([np.float16, np.float32][i // 2 % 2]))
    return str(root)


def test_library_builds_from_the_ports_source_under_build():
    lib = native.get_lib()
    path = native.library_path()
    assert lib._name == str(path) and path.is_file()
    assert path.parent == native.BUILD_DIR and native.BUILD_DIR.parts[-2:] == ("build", "fit_tpu_torch")
    assert path.name.startswith("libfitpacker_") and native.SRC.parent.name == "native"
    assert native.SRC.parts[-4:-1] == ("fit_tpu_torch", "data", "native")
    assert native.get_lib() is lib


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch, latent_root):
    bad = tmp_path / "packer.cpp"
    bad.write_text(native.SRC.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build the native packer(.|\n)*error"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="failed to build"):  # no silent fall back to numpy
        LatentLoader(LatentFolderDataset(latent_root), 4)
    assert not LatentLoader(LatentFolderDataset(latent_root), 4, native=False)._native
    assert list((tmp_path / "build").iterdir()) == []  # no half-written library left behind
    monkeypatch.setattr(native.shutil, "which", lambda name: None)  # no g++ on PATH
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.get_lib()


@pytest.mark.parametrize("flip", [0, 1])
def test_pack_matches_numpy_patchify(latent_root, flip):
    paths = [p for p, _ in LatentFolderDataset(latent_root).entries[:4]]
    tokens, mask, hw, lengths = native.pack_batch_native(paths, np.full(4, flip), 2, 256, 16)
    for i, p in enumerate(paths):
        lat = np.load(p).astype(np.float32)
        want = patchify_np(np.ascontiguousarray(lat[..., ::-1] if flip else lat), 2)
        t = min(want.shape[0], 256)  # an over-long latent is cut to the budget
        assert lengths[i] == want.shape[0] and tuple(hw[i]) == lat.shape[1:]
        np.testing.assert_array_equal(tokens[i, :t], want[:t])
        assert not tokens[i, t:].any() and mask[i, :t].all() and not mask[i, t:].any()
    with pytest.raises(ValueError, match="flips"):
        native.pack_batch_native(paths, np.zeros(3), 2, 256, 16)


def test_a_bad_file_raises_naming_it(latent_root, tmp_path):
    """The batch is packed as runs of samples in threads: a failing sample
    in any run raises with its own path."""
    paths = [p for p, _ in LatentFolderDataset(latent_root).entries[:11]]
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not an npy file")
    paths[9] = str(bad)
    with pytest.raises(IOError, match="bad.npy"):
        native.pack_batch_native(paths, np.zeros(11), 2, 256, 16)
    with pytest.raises(IOError, match="bad.npy"):
        native.pack_batch_gather_native(paths, np.zeros(11), np.zeros((11, 8), np.int32), 2, 16)


def _batches(loader, epochs=(0, 1)):
    return [b for e in epochs for b in loader.epoch_batches(e)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("hflip", [True, False])
@pytest.mark.parametrize("port_native", [True, False])
@pytest.mark.parametrize("mode", ["pad", "bucket"])
def test_loader_bytes_match_fit_tpu(latent_root, mode, port_native, hflip, drop_last):
    kw = dict(mode=mode, seed=5, drop_last=drop_last, buckets=BUCKETS)
    port = LatentLoader(LatentFolderDataset(latent_root, hflip=hflip), 4, native=port_native, **kw)
    assert port._native == port_native
    got = _batches(port)
    for ref_native in (True, False):
        ref = RefLoader(RefDataset(latent_root, hflip=hflip), 4, native=ref_native, **kw)
        assert ref._native == ref_native
        _assert_same(got, _batches(ref))
    assert len(got) == 2 * len(port) == 2 * (3 if drop_last else 4)


def test_drop_last_false_keeps_the_partial_batch(latent_root):
    ds = LatentFolderDataset(latent_root)
    kept, dropped = LatentLoader(ds, 4, drop_last=False), LatentLoader(ds, 4)
    assert (len(kept), len(dropped)) == (4, 3)
    sizes = [b["tokens"].shape[0] for b in kept.epoch_batches(0)]
    assert sizes == [4, 4, 4, 2]
    assert [b["tokens"].shape[0] for b in dropped.epoch_batches(0)] == [4, 4, 4]
    # the full batches are the same either way
    for a, b in zip(kept.epoch_batches(0), dropped.epoch_batches(0)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("num_shards", [2, 3])
def test_shards_are_disjoint_and_match_fit_tpu(latent_root, num_shards):
    """Each shard's batches equal fit_tpu's for the same shard; together
    the shards' plans hold each sample at most once and miss fewer than
    ``num_shards``. ``__len__`` is fit_tpu's: batches of the even share."""
    ds, ref_ds = LatentFolderDataset(latent_root, hflip=False), RefDataset(latent_root, hflip=False)
    seen = []
    for shard in range(num_shards):
        kw = dict(seed=2, drop_last=False, shard_id=shard, num_shards=num_shards)
        port = LatentLoader(ds, 2, **kw)
        got = _batches(port, epochs=(0,))
        _assert_same(got, _batches(RefLoader(ref_ds, 2, **kw), epochs=(0,)))
        idxs = [i for idx, _ in port._batch_plan(0) for i in idx]
        seen += idxs
        assert len(port) == -(-(len(ds) // num_shards) // 2)
    assert len(seen) == len(set(seen)) and len(seen) >= len(ds) - num_shards + 1
    with pytest.raises(ValueError, match="shard_id"):
        LatentLoader(ds, 2, shard_id=2, num_shards=2)


@pytest.mark.parametrize("mode", ["pad", "bucket", "randint"])
def test_profile_loader_modes(latent_root, mode):
    """profile_loader over each mode, past an epoch boundary; the randint
    loader's batches equal fit_tpu's."""
    cls = profile_loaders._RandintLoader if mode == "randint" else LatentLoader
    loader = cls(LatentFolderDataset(latent_root), 4, mode="pad" if mode == "pad" else "bucket")
    stats = profile_loaders.profile_loader(loader, 5, with_cprofile=mode == "bucket")
    assert stats["batches"] == 5 and stats["ms_per_batch"] > 0
    assert (stats["profile"] is not None) == (mode == "bucket")
    if mode == "randint":
        ref = ref_profile._RandintLoader(RefDataset(latent_root), 4, mode="bucket", native=False)
        _assert_same(list(loader.epoch_batches(1)), list(ref.epoch_batches(1)))
    with pytest.raises(ValueError, match="no batch"):
        profile_loaders.profile_loader(LatentLoader(LatentFolderDataset(latent_root), 64), 1)


def test_profile_loaders_main(latent_root, capsys):
    profile_loaders.main(["--root", latent_root, "--batches", "2", "--batch-size", "4"])
    out = capsys.readouterr().out
    for name in ("pad", "bucket", "randint"):
        assert f"[{name}] 2 batches" in out
