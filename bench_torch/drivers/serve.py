"""Serving: ``SamplingServer`` in-process under an open loop of requests.

Traffic keys: ``rate`` (requests a second), ``sizes`` (a mix of (height,
width, share) in pixels), ``batch_size``, ``max_batch_wait_s``,
``sampler``, ``steps``, ``cfg_scale`` and ``slice_seconds`` (arrivals
profiled after the window in a traced run). Requests fall due on the
schedule of :func:`bench_torch.traffic.arrivals`, whether or not earlier
ones have finished; each has a label, a size and a seed of its own, and
its latency runs from its due time to its future's resolution. With a
``vae`` in the configuration the server decodes, and an answer is an
(H, W, 3) uint8 image.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from bench_torch import common, traffic
from bench_torch.reference import diffusion as ref_diffusion
from bench_torch.reference import fit as ref_fit
from bench_torch.reference import vae as ref_vae
from bench_torch.reference.precision import PRECISIONS
from bench_torch.trace import profiled_slice

def requests(run, tag: str, seconds: float):
    """(due time, label, (height, width), seed) of each request of a
    stretch of the open loop."""
    m, tr = run.config["model"], run.traffic
    r = traffic.rng(run.seed, tag)
    due = traffic.arrivals(tr["rate"], seconds, r)
    sizes = traffic.shuffled_sizes(tr["sizes"], len(due), r)
    labels = traffic.labels(r, len(due), m["num_classes"])
    seeds = r.integers(0, 2**31, size=len(due))
    return [(float(d), int(y), s, int(k)) for d, y, s, k in zip(due, labels, sizes, seeds)]


def p95_ms(latencies_s) -> float:
    """The 95th percentile, in ms, over every request given (numpy's
    linear interpolation); infinite when none was answered."""
    lat = np.asarray(latencies_s, np.float64) * 1e3
    return float(np.percentile(lat, 95)) if lat.size else float("inf")


def setup(run) -> Dict:
    import torch
    from fit_tpu_torch.serve import SamplingServer

    dev = torch.device(run.device)
    m, tr = run.config["model"], run.traffic
    model = common.build_fit(run, dev)
    run.mark("denoiser weights made")
    vae = common.build_vae(run, dev)
    decode = vae.decode
    spans = []  # perf_counter (start, end) of each decode call on the host

    def traced_decode(latents):
        t = time.perf_counter()
        out = decode(latents)
        spans.append((t, time.perf_counter()))
        return out

    vae.decode = traced_decode
    server = SamplingServer(
        model, batch_size=tr["batch_size"], max_batch_wait_s=tr["max_batch_wait_s"], num_sampling_steps=tr["steps"],
        cfg_scale=tr["cfg_scale"], sampler=tr["sampler"], num_classes=m["num_classes"], max_size=m["max_size"],
        max_length=m["max_length"], device=dev, vae=vae,
    )
    # one full batch with every size of the mix: the kernels, one decode shape each
    server.warmup(sizes=[(int(h), int(w)) for h, w, _ in tr["sizes"]])
    run.mark("server warm")
    return {"server": server, "device": dev, "decode_spans": spans}


def offer(server, reqs, t0: float):
    """Submit each request at its due time; returns one record a request:
    [due, done time or None, future or exception]."""
    from fit_tpu_torch.serve import ServerOverloaded

    records = []
    for due, label, (h, w), seed in reqs:
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec = [t0 + due, None, None, time.perf_counter() - (t0 + due)]
        try:
            fut = server.submit(label, h, w, seed=seed)
        except ServerOverloaded as exc:
            rec[2] = exc
        else:
            rec[2] = fut
            fut.add_done_callback(lambda _f, rec=rec: rec.__setitem__(1, time.perf_counter()))
        records.append(rec)
    return records


def _settle(records, deadline: float) -> None:
    for rec in records:
        fut = rec[2]
        if hasattr(fut, "result"):
            try:
                fut.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # noqa: BLE001 — a failed answer is counted below
                pass


def window(run, state) -> Dict:
    server = state["server"]
    reqs = requests(run, "window", run.seconds)
    run.t_window = time.time()
    t0 = time.perf_counter()
    records = offer(server, reqs, t0)
    close = t0 + run.seconds
    if time.perf_counter() < close:
        time.sleep(close - time.perf_counter())
    stats = server.stats()
    backlog = sum(1 for r in records if hasattr(r[2], "done") and not r[2].done())
    _settle(records, close + 60.0)
    lat, failed, answers = [], 0, {}
    for i, (due, done, fut, _late) in enumerate(records):
        ok = hasattr(fut, "done") and fut.done() and fut.exception() is None and done is not None
        if ok:
            lat.append(done - due)
            answers[i] = fut.result()
        else:
            failed += 1
    late = max(r[3] for r in records)
    p95 = p95_ms(lat)
    run.log(f"rate {run.traffic['rate']} req/s: {len(records)} requests, {failed} failed, p50 "
            f"{np.percentile(np.asarray(lat) * 1e3, 50) if lat else float('nan'):.1f} ms, p95 {p95:.1f} ms, "
            f"occupancy {stats['occupancy']:.4f}, backlog at close {backlog}, generator late by at most "
            f"{late * 1e3:.1f} ms")
    state.update(reqs=reqs, answers=answers, failed=failed)
    return {
        "end_to_end": {"request_p95_ms": p95},
        "occupancy": stats["occupancy"],
        "backlog": backlog,
        "requests": len(records),
    }


def traced_slice(run, state, obs):
    """``slice_seconds`` more of the open loop under the profiler, until
    every answer of it is back."""
    import torch

    reqs = requests(run, "slice", run.traffic["slice_seconds"])
    with profiled_slice(torch) as box:
        records = offer(state["server"], reqs, time.perf_counter())
        _settle(records, time.perf_counter() + 60.0)
    obs["decode_spans"] = list(state["decode_spans"])
    return box["trace"]


def check_picks(run, state) -> List[int]:
    """One answered request of each size in the mix, drawn from the seed."""
    r = traffic.rng(run.seed, "check")
    picks = []
    for h, w, _ in run.traffic["sizes"]:
        ids = [i for i in state["answers"] if tuple(state["reqs"][i][2]) == (int(h), int(w))]
        if ids:
            picks.append(int(r.choice(ids)))
    return picks


def reference_images(run, reqs, device, precision="fp32") -> List[np.ndarray]:
    """The reference's uint8 images of requests (due, label, size, seed):
    the server's canvas noise of the request's seed, its first tokens as
    the (h, w) latent, DPM-Solver++ with guidance, the VAE decode."""
    import torch

    m, v, tr = run.config["model"], run.config["vae"], run.traffic
    common.reference_mode()
    w = common.fit_weights(run, device)
    wv = common.vae_weights(run, device)
    pr = PRECISIONS[precision]
    p, f = m["patch_size"], m["vae_scale"]
    steps = {"dpm": ref_diffusion.dpm_solver_pp_2m, "ddim": ref_diffusion.ddim}[tr["sampler"]]
    out = []
    with torch.no_grad():
        for _due, label, (hp, wp), seed in reqs:
            h, wd = hp // f, wp // f
            canvas = np.random.default_rng(seed).standard_normal(
                (m["in_channels"], m["max_size"], m["max_size"]), dtype=np.float32)
            tokens = ref_fit.patchify(torch.from_numpy(canvas)[None].to(device), p)[:, : (h // p) * (wd // p)]
            y = torch.tensor([label], device=device)
            cs = ref_fit.grid_tables(m, [(h, wd)], device, ntk=True)
            lengths = torch.tensor([tokens.shape[1]], device=device)

            def eps_fn(x, t):
                return ref_fit.guided_eps(w, m, x, t, y, cs, lengths, tr["cfg_scale"], pr)

            lat = ref_fit.unpatchify(steps(eps_fn, tokens, tr["steps"]), h, wd, p, m["in_channels"])
            img = ref_vae.decode(wv, v, lat / v["scaling_factor"], pr)
            out.append(ref_vae.to_uint8(img[0].cpu().numpy()))
    return out


def image_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute difference of two uint8 images, in levels."""
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def check(run, state):
    server = state.pop("server")
    server.close()
    del server
    common.free_card()
    picks = check_picks(run, state)
    ref = reference_images(run, [state["reqs"][i] for i in picks], state["device"])
    gaps = [image_gap(state["answers"][i], r) for i, r in zip(picks, ref)]
    run.log(f"image gaps (levels) of {len(gaps)} requests: {[float(f'{g:.4g}') for g in gaps]}")
    compared = {"image_mean_abs_err": {"value": max(gaps) if gaps else float("inf"),
                                       "limit": run.limits["image_mean_abs_err"]}}
    return compared, len(state["reqs"]), state["failed"]


def control(run):
    """The fp8 control against the fp32 reference on one request of each
    size, drawn from the seed."""
    import torch

    dev = torch.device(run.device)
    reqs = requests(run, "control", 30.0)
    r = traffic.rng(run.seed, "control-picks")
    picks = []
    for h, w, _ in run.traffic["sizes"]:
        ids = [i for i, q in enumerate(reqs) if tuple(q[2]) == (int(h), int(w))]
        picks.append(reqs[int(r.choice(ids))])
    ref = reference_images(run, picks, dev)
    low = reference_images(run, picks, dev, "fp8")
    return {"control_fp8": {"image_mean_abs_err": max(image_gap(a, b) for a, b in zip(low, ref))}}
