"""Checkpoints of the whole training state.

Counterpart of ``fit_tpu/utils/checkpoint.py``'s ``CheckpointManager``
(keep-all by default, the same method names): each save writes
``ckpt_<step>.pt`` (``torch.save`` of the model's and the optimizer's state
dicts, the EMA shadow and the step) and ``host_<step>.json`` with the
host-side state that rides along (epoch, batch index, the generators'
states, the optimizer-state dtype). Saves are synchronous and atomic: a
file is written under a temporary name and renamed.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import torch

from fit_tpu_torch.train.state import TrainState

__all__ = ["CheckpointManager"]

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Save and restore the train state under ``directory``; keeps every
    checkpoint."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _write(self, name: str, write) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{name}.")
        os.close(fd)
        try:
            write(tmp)
            os.replace(tmp, self._path(name))
        except BaseException:
            os.unlink(tmp)
            raise

    def steps(self):
        """The saved steps, ascending."""
        found = (_CKPT.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: TrainState, host_state: Optional[dict] = None) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
            "step": state.step,
        }
        self._write(f"ckpt_{step}.pt", lambda p: torch.save(payload, p))
        if host_state is not None:
            def write_json(p):
                with open(p, "w") as f:
                    json.dump(host_state, f)

            self._write(f"host_{step}.json", write_json)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, state: Optional[TrainState] = None):
        """Load a checkpoint (the latest by default) into ``state``, in
        place. Returns ``(state, host_state)``, ``(None, None)`` when there
        is none; without ``state`` the first item is the saved payload."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        device = next(state.model.parameters()).device if state is not None else "cpu"
        payload: Any = torch.load(self._path(f"ckpt_{step}.pt"), map_location=device, weights_only=True)
        if state is not None:
            state.model.load_state_dict(payload["model"])
            state.optimizer.load_state_dict(payload["optimizer"])
            with torch.no_grad():
                for name, e in state.ema.items():
                    e.copy_(payload["ema"][name])
            state.step = int(payload["step"])
            payload = state
        host_state = None
        if os.path.exists(self._path(f"host_{step}.json")):
            with open(self._path(f"host_{step}.json")) as f:
                host_state = json.load(f)
        return payload, host_state

    def close(self) -> None:
        """Nothing stays open between saves."""
