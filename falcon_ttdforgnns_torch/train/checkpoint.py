"""Checkpoint and restore (port of ``falcon_ttdforgnns_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file ``step_{n}.pt`` holding
``{"variables": ..., "opt_state": ..., "extra": ...}``: nested dicts and
lists of tensors and plain Python values, written to ``step_{n}.pt.tmp``
and moved into place by ``os.replace``, so a crash mid-save leaves only a
``.tmp`` leftover, which :func:`latest_checkpoint` skips.  Tensors are
saved as they lie (on the card or the CPU) and restored onto the CPU;
:meth:`SageTrainer.restore` copies them into the trainer's own tensors.
The file is read with ``weights_only=True``: tensors, containers and
Python scalars only.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(ckpt_dir: str, step: int, variables: Dict[str, Any], opt_state: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic save of the full training state; returns the path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.pt")
    torch.save({"variables": variables, "opt_state": opt_state, "extra": extra or {}},
               path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def restore_checkpoint(path: str, target: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The saved ``{"variables", "opt_state", "extra"}`` with every tensor on
    the CPU.  With ``target``, the top-level keys of each of its entries
    must be the saved ones (a checkpoint of another configuration raises)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    for key, want in (target or {}).items():
        got = state.get(key)
        if isinstance(want, dict) and (not isinstance(got, dict) or set(got) != set(want)):
            raise ValueError(f"checkpoint {path}: {key!r} holds "
                             f"{sorted(got) if isinstance(got, dict) else got!r}, "
                             f"expected {sorted(want)}")
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest step in ``ckpt_dir``, or None; ``.tmp``
    leftovers of an interrupted save are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                cands.append((int(name.split("_")[1].split(".")[0]),
                              os.path.join(ckpt_dir, name)))
            except ValueError:
                continue
    return max(cands)[1] if cands else None
