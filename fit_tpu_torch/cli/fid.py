"""Sample-quality command line: FID, sFID, Inception Score and improved
Precision/Recall of a directory of images, with ``fit_tpu``'s flags and
``--device``.

InceptionV3 features (``fit_tpu_torch.eval.inception``, fp32 on the card)
for every metric come from one network pass over the images
(``make_suite_extractor``); the statistics and distances are computed on
the host (``fit_tpu_torch.eval.fid``, ``.metrics``).

    # FID of generated samples against a reference set (a directory or a .npz)
    python -m fit_tpu_torch.cli.fid --samples-dir samples/ --reference ref_stats.npz \\
        --inception-weights pt_inception-2015-12-05.pth

    # the whole suite (IS needs the checkpoint's fc head; pr the reference's
    # raw features, which --save-stats writes)
    python -m fit_tpu_torch.cli.fid --samples-dir samples/ --reference ref_stats.npz \\
        --inception-weights ... --metrics fid,sfid,is,pr

    # reference statistics, once (keys mu, sigma, feats, mu_s, sigma_s: the
    # same file fit_tpu.cli.fid writes and reads)
    python -m fit_tpu_torch.cli.fid --samples-dir imagenet_val/ \\
        --inception-weights ... --save-stats ref_stats.npz

Runs on the card unless ``--device cpu``. The images of one batch must
share a size (``np.stack``), as in ``fit_tpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _iter_images(path: str):
    """Yield (3, H, W) float32 images in [0, 1] from a directory tree, in
    sorted path order."""
    from PIL import Image

    files = []
    for dirpath, _, names in os.walk(path):
        files.extend(os.path.join(dirpath, f) for f in names if os.path.splitext(f)[1].lower() in _IMG_EXTS)
    files.sort()
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    for f in files:
        with Image.open(f) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
        yield np.transpose(img, (2, 0, 1))


def _extract_dir(path: str, extractors: dict, batch_size: int) -> dict:
    """One pass over a directory through every extractor (name -> numpy in,
    numpy or dict of named arrays out); returns name -> (N, D)."""
    out: dict = {}
    buf = []
    n = 0

    def flush():
        nonlocal n
        batch = np.stack(buf)
        for name, fn in extractors.items():
            r = fn(batch)
            for k, v in (r.items() if isinstance(r, dict) else [(name, r)]):
                out.setdefault(k, []).append(v)
        n += len(buf)
        buf.clear()

    for img in _iter_images(path):
        buf.append(img)
        if len(buf) == batch_size:
            flush()
    if buf:
        flush()
    print(f"extracted features for {n} images from {path}")
    return {name: np.concatenate(parts, axis=0) for name, parts in out.items()}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Sample-quality metrics: FID / Inception Score / Precision-Recall (InceptionV3)"
    )
    parser.add_argument("--samples-dir", type=str, required=True, help="directory of generated images")
    parser.add_argument("--reference", type=str, default=None,
                        help="reference image directory or precomputed stats .npz "
                             "(with arrays mu, sigma; PR additionally needs feats)")
    parser.add_argument("--inception-weights", type=str, required=True,
                        help="torchvision or pytorch-fid InceptionV3 .pth/.pt")
    parser.add_argument("--metrics", type=str, default="fid",
                        help="comma-separated subset of fid,sfid,is,pr (default fid). sfid: spatial FID over "
                             "the mixed_6/conv 2023-d features (ADM suite). is: Inception Score of the samples "
                             "(needs the checkpoint's fc head). pr: improved Precision/Recall vs the reference set")
    parser.add_argument("--variant", type=str, default="fid", choices=("fid", "torchvision"),
                        help="pooling semantics: pytorch-fid's FIDInception (default, comparable with published "
                             "numbers) or stock torchvision")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--save-stats", type=str, default=None,
                        help="write samples-dir statistics (mu, sigma, and raw feats for PR) to this .npz and exit")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    bad = set(metrics) - {"fid", "sfid", "is", "pr"}
    if bad:
        parser.error(f"unknown --metrics {sorted(bad)} (valid: fid,sfid,is,pr)")

    from fit_tpu_torch.eval.fid import feature_statistics, frechet_distance
    from fit_tpu_torch.eval.inception import load_torch_inception, make_suite_extractor

    model = load_torch_inception(args.inception_weights)
    # one trunk pass gives every embedding asked for; --save-stats always
    # keeps the spatial statistics, so a saved reference serves later sfid runs
    want_spatial = "sfid" in metrics or bool(args.save_stats)
    suite = make_suite_extractor(model, variant=args.variant, spatial=want_spatial, probs="is" in metrics,
                                 device=args.device)
    extractors = {"suite": suite}

    sample = _extract_dir(args.samples_dir, extractors, args.batch_size)
    mu1, cov1 = feature_statistics(sample["pool3"])
    if want_spatial:
        mu1_s, cov1_s = feature_statistics(sample["spatial"])
    if args.save_stats:
        np.savez(args.save_stats, mu=mu1, sigma=cov1, feats=sample["pool3"], mu_s=mu1_s, sigma_s=cov1_s)
        print(f"saved statistics to {args.save_stats}")
        return

    ref_feats = None
    mu2 = cov2 = mu2_s = cov2_s = None
    if args.reference:
        if args.reference.endswith(".npz"):
            ref = np.load(args.reference)
            mu2, cov2 = ref["mu"], ref["sigma"]
            if "feats" in ref:
                ref_feats = ref["feats"]
            if "mu_s" in ref:
                mu2_s, cov2_s = ref["mu_s"], ref["sigma_s"]
            elif "sfid" in metrics:
                parser.error("sfid needs spatial reference statistics (mu_s/sigma_s) — regenerate the .npz with "
                             "this CLI's --save-stats, or pass a reference image directory")
        else:
            ref = _extract_dir(args.reference, extractors, args.batch_size)
            ref_feats = ref["pool3"]
            mu2, cov2 = feature_statistics(ref_feats)
            if want_spatial:
                mu2_s, cov2_s = feature_statistics(ref["spatial"])
    elif "fid" in metrics or "sfid" in metrics or "pr" in metrics:
        parser.error("--reference is required for fid/sfid/pr unless --save-stats is given")

    if "fid" in metrics:
        print(f"FID: {frechet_distance(mu1, cov1, mu2, cov2):.4f}")
    if "sfid" in metrics:
        print(f"sFID: {frechet_distance(mu1_s, cov1_s, mu2_s, cov2_s):.4f}")
    if "is" in metrics:
        from fit_tpu_torch.eval.metrics import inception_score

        mean, std = inception_score(sample["probs"])
        print(f"Inception Score: {mean:.4f} +/- {std:.4f}")
    if "pr" in metrics:
        if ref_feats is None:
            parser.error("pr needs raw reference features: pass a reference image dir, or an .npz written by "
                         "this CLI's --save-stats (which includes feats)")
        from fit_tpu_torch.eval.metrics import precision_recall

        p, r = precision_recall(ref_feats, sample["pool3"])
        print(f"Precision: {p:.4f}  Recall: {r:.4f}")


if __name__ == "__main__":
    main()
