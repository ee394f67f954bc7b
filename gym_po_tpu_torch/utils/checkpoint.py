"""Checkpoint and resume, PyTorch port of :mod:`gym_po_tpu.utils.checkpoint`.

A checkpoint is one ``torch.save`` file of plain tensors per step,
``<directory>/<step>.pt``; the last three steps are kept, as the JAX
package's orbax manager keeps them (``max_to_keep=3``).  It holds every
tensor of the state (a PPO or recurrent PPO train state: the flat
parameters, Adam's count and moments, the env observations and every field
of the env state, the hidden state and reset flags; or a bare env-state
dataclass), each generator's state and the integer fields
(``update_idx``).  The model is not saved: its parameters are views of the
flat buffer.  Files are read with ``weights_only=True``.

The format is the port's own: it cannot read the JAX package's orbax
checkpoints (orbax imports jax), nor they the port's.

Resume is exact because the generator's state is saved with the rest.
:func:`restore_checkpoint` restores in place, into the template's own
tensors and generator: the model's parameters are views of the flat
buffer, and a captured collect graph reads its generator and weights where
they lie, so new tensors would silently detach both.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, List, Optional

import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

MAX_TO_KEEP = 3
_FILE = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(directory))
                  if m)


def _tree(x) -> Any:
    """The state as nested dicts of CPU tensors, generator states and ints."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, torch.Generator):
        return {"generator_state": x.get_state()}
    if dataclasses.is_dataclass(x):
        return {f.name: _tree(getattr(x, f.name)) for f in dataclasses.fields(x)
                if not isinstance(getattr(x, f.name), nn.Module)}
    if isinstance(x, (bool, int, float)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _restore(template, saved, where: str, seen: set):
    """Copy ``saved`` into ``template`` in place; returns the value for an
    immutable leaf (an int), a copy for a tensor whose storage an earlier
    field of the template shares (``reset_vec`` may hand two fields one
    zeros tensor), and the template itself otherwise."""
    if isinstance(template, torch.Tensor):
        if template.shape != saved.shape or template.dtype != saved.dtype:
            raise ValueError(f"{where}: checkpoint holds {saved.dtype} "
                             f"{tuple(saved.shape)}, the template "
                             f"{template.dtype} {tuple(template.shape)}")
        ptr = template.untyped_storage().data_ptr()
        if ptr in seen:
            template = template.clone()
        seen.add(template.untyped_storage().data_ptr())
        template.copy_(saved)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(saved["generator_state"])
        return template
    if dataclasses.is_dataclass(template):
        for name, value in saved.items():
            leaf = _restore(getattr(template, name), value, f"{where}.{name}",
                            seen)
            if leaf is not getattr(template, name):
                object.__setattr__(template, name, leaf)  # frozen ones too
        return template
    return type(template)(saved)


def save_checkpoint(directory: str, step: int, state: Any) -> None:
    """Save ``state`` (a train state or an env-state dataclass) at ``step``
    under ``directory`` (made if missing), keeping the last three steps."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{int(step)}.pt")
    tmp = path + ".tmp"
    torch.save(_tree(state), tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(os.path.join(directory, f"{old}.pt"))


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """Restore the state saved at ``step`` (default: the latest) into
    ``template``, in place, and return it.

    ``template`` is a state of the same structure, shapes and dtypes (e.g.
    a freshly initialised train state for the same env and config); its
    tensors keep their devices (a tensor that shares its storage with an
    earlier one of the template gets a storage of its own).  Raises
    ``FileNotFoundError`` when ``directory`` holds no checkpoint (or none
    at ``step``).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"{int(step)}.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at step {step} under {directory}")
    saved = torch.load(path, weights_only=True)
    return _restore(template, saved, type(template).__name__, set())


def latest_step(directory: str) -> Optional[int]:
    """The highest saved step under ``directory``, or ``None``."""
    steps = _steps(directory)
    return steps[-1] if steps else None
