"""State checkpointing: pickle save/load keyed by field name.

The pickle layout of ``odil_tpu/checkpoint.py`` (``checkpoint_save:20``,
``checkpoint_load:35``): ``{"fields": {key: [numpy arrays]}, "optimizer":
{slot: [numpy arrays] or a number}}``, each field's arrays in the canonical
flat order.  A checkpoint written by either package loads into the other.
Slots stored in bfloat16 are written as float32 (numpy has no bfloat16).
The JAX package's asynchronous Orbax checkpointer is not ported
(``--checkpoint_format orbax`` raises; ROADMAP.md).
"""

import pickle

import numpy as np
import torch

from .fields import field_arrays, set_field_arrays

__all__ = ["checkpoint_save", "checkpoint_load"]


def _numpy(a):
    if torch.is_tensor(a):
        a = a.detach()
        if a.is_floating_point() and a.element_size() < 4:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def checkpoint_save(domain, state, path, optstate=None):
    """Saves state (and optionally optimizer slot variables) to `path`."""
    fields = {key: [_numpy(a) for a in field_arrays(state.fields[key])] for key in state.fields}
    payload = {"fields": fields}
    if optstate is not None:
        payload["optimizer"] = {
            k: [_numpy(a) for a in v] if isinstance(v, (list, tuple)) else _numpy(v) for k, v in optstate.items()
        }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def checkpoint_load(domain, state, path, skip_missing=True, keys=None):
    """Loads fields from a checkpoint into `state` (in place), as tensors on
    the domain's device in its dtype.

    Returns the optimizer slot dict (numpy arrays) if present, else None."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    data = payload.get("fields", dict())
    keys = keys or state.fields.keys()
    for key in keys:
        if key not in data:
            if not skip_missing:
                raise RuntimeError(f"Field {key} not found in {path}")
            continue
        arrays = data[key]
        if not isinstance(arrays, list):
            arrays = [arrays]
        set_field_arrays(state.fields[key], [domain.cast(np.asarray(a)) for a in arrays])
    return payload.get("optimizer")
