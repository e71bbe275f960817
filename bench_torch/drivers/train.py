"""Training: ``Trainer.fit`` on synthetic latents written into the checkout.

Traffic keys: ``packing`` ("pad" or "bucket"), ``latents`` (how many files
the set-up writes), ``sizes`` (a mix of (height, width, share) in pixels),
``trainer_seed`` (the Trainer's ``global_seed``: its loader order, bucket
draws, timesteps and noise; fixed, so every seed runs the same bucket
sequence), ``warm_steps``, ``num_workers``, ``log_every`` and
``slice_steps`` (steps profiled after the window in a traced run).

The Trainer runs as it is, its loader, prefetch and logging included.
The benchmark wraps its ``train_step``: after each step it records a CUDA
event on the stream (no sync), so the window is the device time from the
event after the last warm step to the event after the last whole step;
before steps 2 and 4 it reads, for the comparison, the first gradient
from AdamW's first moment and the change of the parameters and the EMA.
"""

from __future__ import annotations

import contextlib
import shutil
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from bench_torch import common, flops, traffic, weights
from bench_torch.reference import train as ref_train
from bench_torch.reference.precision import PRECISIONS
from bench_torch.trace import profiled_slice

K2_KERNELS = ("bwd_prologue_kernel", "bwd_dkdv_mma_kernel", "bwd_dq_mma_kernel", "bwd_dkdv_tf32_kernel",
              "bwd_dq_tf32_kernel")
ROOT = Path(__file__).resolve().parents[2]
CHECK_STEPS = 3


class WindowClosed(Exception):
    """Raised from the wrapped step to leave ``Trainer.fit``."""


def dataset(run):
    """The cell's latents (fp16, (C, h, w)) with labels and file names, in
    the loader's file order (sorted paths)."""
    m, tr = run.config["model"], run.traffic
    n = tr["latents"]
    r = traffic.rng(run.seed, "latents")
    sizes = traffic.shuffled_sizes(tr["sizes"], n, r)
    labels = traffic.labels(r, n, m["num_classes"])
    f = m["vae_scale"]
    lat = [r.standard_normal((m["in_channels"], h // f, w // f), dtype=np.float32).astype(np.float16)
           for h, w in sizes]
    names = [f"c{int(y):03d}/{i:05d}.npy" for i, y in enumerate(labels)]
    order = sorted(range(n), key=lambda i: names[i])
    present = sorted({int(y) for y in labels})
    dense = {c: k for k, c in enumerate(present)}  # the loader numbers the class folders present
    return [lat[i] for i in order], [dense[int(labels[i])] for i in order], [names[i] for i in order]


def write_dataset(run, root: Path):
    """Write the latents as .npy files, one folder a class."""
    if root.exists():
        shutil.rmtree(root)
    lats, labels, names = dataset(run)
    for d in sorted({n.split("/")[0] for n in names}):
        (root / d).mkdir(parents=True)
    for lat, name in zip(lats, names):
        np.save(root / name, lat)
    return lats, labels


def train_config(run, work: Path):
    from fit_tpu_torch.utils.config import TrainConfig

    m, t, tr = run.config["model"], run.config["train"], run.traffic
    return TrainConfig(
        feature_path=str(work / "latents"), feature_val_path="", results_dir=str(work / "results"),
        model=m["name"], image_size=m["image_size"], num_classes=m["num_classes"], epochs=10**6,
        global_batch_size=t["global_batch_size"], global_seed=tr["trainer_seed"], num_workers=tr["num_workers"],
        log_every=tr["log_every"], ckpt_every_epochs=t["ckpt_every_epochs"], resume_from_checkpoint="none",
        learning_rate=t["learning_rate"], weight_decay=t["weight_decay"], ema_decay=t["ema_decay"],
        grad_accum=t["grad_accum"], compute_dtype=m["dtype"], optimizer_state_dtype=t["optimizer_state_dtype"],
        packing=tr["packing"], patch_size=m["patch_size"], vae_scale=m["vae_scale"], channels=m["in_channels"],
    )


def _leaf_norms(torch, tensors: List) -> "object":
    return torch.stack(torch._foreach_norm([x.float() for x in tensors]))


class Stepper:
    """The wrapped ``train_step``: warm steps, the check's readings, the
    window's events and the traced slice, then :class:`WindowClosed`."""

    def __init__(self, run, trainer, names):
        import torch

        self.torch = torch
        self.run, self.trainer, self.names = run, trainer, names
        self.inner = trainer.train_step
        self.warm = max(run.traffic["warm_steps"], CHECK_STEPS + 1)
        self.losses, self.first_grad, self.moved, self.ema_moved = [], None, None, None
        self.events, self.lengths = [], []
        self.phase = "warm"
        self.slice_lengths: List = []
        self.profiler = None
        self.done = 0
        self.on_card = run.device == "cuda"
        self.peak = 0

    def _readings(self, state):
        torch, names = self.torch, self.names
        params = dict(state.model.named_parameters())
        k = state.step
        if k == 1:  # AdamW's first moment after one step is (1 - beta1) * g
            opt = state.optimizer
            self.first_grad = _leaf_norms(torch, [opt.state[params[n]]["exp_avg"] for n in names]) / 0.1
        if k == CHECK_STEPS:
            w0 = common.fit_weights(self.run, params[names[0]].device)
            self.moved = _leaf_norms(torch, torch._foreach_sub([params[n].detach() for n in names],
                                                                [w0[n] for n in names]))
            self.ema_moved = _leaf_norms(torch, torch._foreach_sub([state.ema[n] for n in names],
                                                                    [w0[n] for n in names]))
            del w0

    def __call__(self, state, batch, generator):
        torch = self.torch
        self._readings(state)
        state, metrics = self.inner(state, batch, generator)
        self.done += 1
        if self.done <= CHECK_STEPS:
            self.losses.append(metrics["loss"].detach())
        if self.phase == "warm" and self.done == self.warm:
            self.run.mark(f"{self.warm} warm steps enqueued")
            if self.on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            self.run.t_window = time.time()
            self.t0 = time.perf_counter()
            self.events.append(self._event())
            self.phase = "window"
        elif self.phase == "window":
            self.events.append(self._event())
            self.lengths.append(batch["lengths"])
            if time.perf_counter() - self.t0 >= self.run.seconds:
                self.peak = torch.cuda.max_memory_allocated() if self.on_card else 0
                self.phase = "slice" if self.run.trace else "done"
                if self.run.trace:
                    self.profiler = contextlib.ExitStack()
                    self.box = self.profiler.enter_context(profiled_slice(torch))
                    self.state = state
                    return state, metrics
        elif self.phase == "slice":
            self.slice_lengths.append(batch["lengths"])
            if len(self.slice_lengths) == self.run.traffic["slice_steps"]:
                self.profiler.close()
                self.phase = "done"
        if self.phase == "done":
            self.state = state
            raise WindowClosed
        return state, metrics

    def _event(self):
        if not self.on_card:
            return _HostEvent()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev


class _HostEvent:
    """A CUDA event's interface on the host clock, for CPU runs of the
    control flow (tests); a run on the card never takes it."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def setup(run) -> Dict:
    import torch
    from fit_tpu_torch.train.loop import Trainer

    dev = torch.device(run.device)
    work = ROOT / "build" / "bench_torch" / "train" / run.name
    if work.exists():
        shutil.rmtree(work)
    write_dataset(run, work / "latents")
    run.mark(f"{run.traffic['latents']} latents written")
    trainer = Trainer(train_config(run, work), device=dev)
    run.mark("Trainer built")
    w = common.fit_weights(run, dev)
    weights.load_into(trainer.model, w)
    names = list(w)
    del w
    stepper = Stepper(run, trainer, names)
    trainer.train_step = stepper
    return {"trainer": trainer, "stepper": stepper, "device": dev, "work": work}


def window(run, state) -> Dict:
    """Warm steps, then the window; with ``--trace 1`` the slice after it,
    in the same ``fit`` call."""
    import torch

    trainer, st = state["trainer"], state["stepper"]
    try:
        trainer.fit()
    except WindowClosed:
        pass
    if state["device"].type == "cuda":
        torch.cuda.synchronize()
    steps = len(st.events) - 1
    window_s = st.events[0].elapsed_time(st.events[-1]) * 1e-3
    m = run.config["model"]
    lengths = [x.reshape(-1).cpu().numpy() for x in st.lengths]
    model_flops = sum(3 * flops.rows_forward_flops(m, ls) for ls in lengths)
    images = sum(len(ls) for ls in lengths)
    return {
        "end_to_end": {"train_img_per_s": images / window_s},
        "window_s": window_s,
        "steps": steps,
        "images": images,
        "model_flops": model_flops,
        "peak_mem_bytes": st.peak,
    }


def traced_slice(run, state, obs):
    """The slice was profiled inside ``fit``, right after the window."""
    st = state["stepper"]
    m = run.config["model"]
    hd = m["hidden_size"] // m["num_heads"]
    bound = 0.0
    for ls in st.slice_lengths:  # (grad_accum, micro) lengths of each step
        for micro in ls.cpu().numpy():
            bound += m["depth"] * flops.k2_bound_s(micro, m["num_heads"], hd)
    obs["slice_k2_bound_s"] = bound
    obs["k2_kernels"] = K2_KERNELS
    return st.box["trace"]


def _leaf_gap(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray) -> float:
    """The worst leaf's gap of norms, against that leaf's reference norm or
    the median leaf's, whichever is larger."""
    floor = np.median(ref[keep])
    return float(np.max(np.abs(prog[keep] - ref[keep]) / np.maximum(ref[keep], floor)))


def readings(prog: dict, ref: dict, names) -> Dict[str, float]:
    """The four numbers compared: each step's loss (relative, the worst
    step), the first gradient, and after three steps the parameters' and
    the EMA's change, each by its worst leaf. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the changes."""
    g_ref = np.array([float(ref["first_grad"][n].norm()) for n in names])
    moved_ref = np.array([float((ref["params"][n] - ref["w0"][n]).norm()) for n in names])
    ema_ref = np.array([float((ref["ema"][n] - ref["w0"][n]).norm()) for n in names])
    everything = np.ones(len(names), bool)
    live = g_ref >= 1e-3 * np.median(g_ref)
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    return {
        "loss_rel_err": float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "grad_leaf_err": _leaf_gap(prog["first_grad"], g_ref, everything),
        "update_leaf_err": _leaf_gap(prog["moved"], moved_ref, live),
        "ema_leaf_err": _leaf_gap(prog["ema_moved"], ema_ref, live),
    }


def reference_run(run, device, precision="fp32", fault=None, lats=None, labels=None) -> dict:
    """The reference's first three steps on the same batches and draws."""
    common.reference_mode()
    m, t, tr = run.config["model"], run.config["train"], run.traffic
    if lats is None:
        lats, labels, _ = dataset(run)
    batches = ref_train.pack_batches(lats, labels, tr["trainer_seed"], t["global_batch_size"], CHECK_STEPS,
                                     tr["packing"], tr["buckets"], m)
    w0 = common.fit_weights(run, device)
    out = ref_train.train(w0, m, t, batches, tr["trainer_seed"], device, CHECK_STEPS, PRECISIONS[precision], fault)
    out["w0"] = w0
    return out


def check(run, state):
    st = state["stepper"]
    names = st.names
    prog = {
        "losses": [float(x) for x in st.losses],
        "first_grad": st.first_grad.cpu().numpy(),
        "moved": st.moved.cpu().numpy(),
        "ema_moved": st.ema_moved.cpu().numpy(),
    }
    attempted = st.done
    dev = state["device"]
    for key in ("trainer", "stepper"):
        state.pop(key)
    del st
    common.free_card()
    ref = reference_run(run, dev)
    values = readings(prog, ref, names)
    run.log(f"losses program {prog['losses']} reference {ref['losses']}")
    del ref
    common.free_card()
    shutil.rmtree(state["work"], ignore_errors=True)
    compared = {k: {"value": v, "limit": run.limits[k]} for k, v in values.items()}
    return compared, attempted * run.config["train"]["global_batch_size"], 0


def control(run):
    """Readings of the fp8 control and of a planted fault (half of every
    micro-batch left out), each in the program's place against the fp32
    reference. A state left unchanged reads 1 on the changes by
    construction and needs no run."""
    import torch

    dev = torch.device(run.device)
    lats, labels, _ = dataset(run)
    ref = reference_run(run, dev, lats=lats, labels=labels)
    names = list(ref["w0"])
    out = {}
    for kind, precision, fault in (("control_fp8", "fp8", None), ("fault_half_batch", "fp32", "half_batch")):
        other = reference_run(run, dev, precision, fault, lats=lats, labels=labels)
        prog = {
            "losses": other["losses"],
            "first_grad": np.array([float(other["first_grad"][n].norm()) for n in names]),
            "moved": np.array([float((other["params"][n] - ref["w0"][n]).norm()) for n in names]),
            "ema_moved": np.array([float((other["ema"][n] - ref["w0"][n]).norm()) for n in names]),
        }
        out[kind] = readings(prog, ref, names)
        del other
        common.free_card()
    return out
