"""Sharded train-state checkpoints for the flagship model.

The port of the JAX package's ``models/checkpoint.py`` on
``torch.distributed.checkpoint`` (DCP) in place of orbax: the train state
(the parameters and the AdamW state, as DTensors for a sharded state, plain
tensors for a whole one) is written under ``directory/<step>``, each rank
writing its own shards, and restored onto a target whose mesh and
placements may differ from the ones it was saved from: DCP reads, for each
rank, the pieces of the saved shards that its target shards cover. So a
checkpoint written by two ranks restores onto one, and back.

Every rank of the state's process group calls ``save_checkpoint`` and
``restore_checkpoint`` together; without a process group they run in one
process. The contract the tests pin: save, restore, continue training
gives the losses of training without the break, bit for bit.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.utils._pytree import tree_map

#: the file DCP writes last, once every rank has written its shards: a step
#: directory that holds it is a complete checkpoint
_METADATA = ".metadata"


def _single_process() -> bool:
    return not dist.is_initialized()


def save_checkpoint(directory: str, step: int, params: Dict[str, Any],
                    opt_state: Any = None, *, force: bool = False) -> str:
    """Write the train state under ``directory/<step>``; returns the path.
    An existing checkpoint at that step raises unless ``force``, which
    writes over it. Across ranks rank 0 looks and every rank takes its
    answer: a rank that looked itself after another had begun writing
    would find the step directory and raise alone."""
    path = os.path.join(os.path.abspath(directory), str(step))
    exists = [os.path.exists(path)]
    if not _single_process():
        dist.broadcast_object_list(exists, src=0)
    if exists[0] and not force:
        raise ValueError(f"checkpoint {path} exists; pass force=True to write over it")
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    dcp.save(state, storage_writer=dcp.FileSystemWriter(path, overwrite=force),
             no_dist=_single_process())
    return path


def restore_checkpoint(directory: str, step: int,
                       like: Dict[str, Any]) -> Tuple[Dict[str, Any], Any]:
    """Restore ``(params, opt_state)`` from ``directory/<step>``.

    ``like`` is ``{"params": ..., "opt_state": ...}`` of tensors in the
    TARGET's layout (DTensors on the current mesh, or whole tensors), for
    example a freshly initialised state: the result has their shapes,
    dtypes and placements, with the saved values. ``like`` itself is left
    as it is. Without ``"opt_state"`` only the parameters are read, and
    the second result is None."""
    path = os.path.join(os.path.abspath(directory), str(step))
    state = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                     {key: like[key] for key in ("params", "opt_state") if key in like})
    dcp.load(state, checkpoint_id=path, no_dist=_single_process())
    return state["params"], state.get("opt_state")


def latest_step(directory: str) -> Optional[int]:
    """The largest integer-named subdirectory of ``directory`` that holds a
    complete checkpoint, or None: the resume probe."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = [int(name) for name in os.listdir(directory)
             if name.isdecimal() and os.path.isfile(os.path.join(directory, name, _METADATA))]
    return max(steps) if steps else None
