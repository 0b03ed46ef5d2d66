"""Checkpoints with ``torch.save``. Port of ``dig_tpu/train/checkpoint.py``
(orbax there): a directory of numbered checkpoints, the newest
``max_to_keep`` kept, and a key-wise partial restore for pretrain ->
finetune loads.

A checkpoint holds any tree of tensors and plain values; ``Run3D`` saves
``{"model": model.state_dict(), "optimizer": optimizer.state_dict()}``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def save(self, state: Any, step: int, metrics: Optional[Dict] = None):
        """Write ``state`` as checkpoint ``step`` (atomically), then drop
        all but the newest ``max_to_keep``."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": step, "state": state, "metrics": metrics}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Any:
        """The state saved at ``step`` (default: the latest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)["state"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def partial_restore(state_dict: Dict[str, torch.Tensor],
                    restored: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every entry that ``restored`` holds under the
    same key and shape replaced by the restored one (pretrain ->
    finetune partial loads); load the result with ``load_state_dict``."""
    out = dict(state_dict)
    for key, leaf in state_dict.items():
        cand = restored.get(key)
        if cand is not None and tuple(cand.shape) == tuple(leaf.shape):
            out[key] = cand
    return out
