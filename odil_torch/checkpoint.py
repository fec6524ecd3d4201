"""State checkpointing: pickle save/load keyed by field name.

The pickle layout of ``odil_tpu/checkpoint.py`` (``checkpoint_save:20``,
``checkpoint_load:35``): ``{"fields": {key: [numpy arrays]}, "optimizer":
{slot: [numpy arrays] or a number}}``, each field's arrays in the canonical
flat order.  A checkpoint written by either package loads into the other.
Slots stored in bfloat16 are written as float32 (numpy has no bfloat16).

``AsyncCheckpointer`` is the counterpart of the JAX package's asynchronous
checkpointer (``odil_tpu/checkpoint.py:56``, ``--checkpoint_format orbax``):
the same API and the same behaviour -- ``save`` returns once the arrays
are snapshotted and a thread writes them -- but not Orbax's files, since
Orbax imports JAX, which the port never does.  Each step is a numbered
directory holding ``state.pickle`` in the pickle layout above, so
``checkpoint_load`` reads it too.
"""

import os
import pickle
import queue
import shutil
import threading

import numpy as np
import torch

from .fields import field_arrays, set_field_arrays

__all__ = ["checkpoint_save", "checkpoint_load", "AsyncCheckpointer"]


def _numpy(a):
    if torch.is_tensor(a):
        a = a.detach()
        if a.is_floating_point() and a.element_size() < 4:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _payload(state, optstate, leaf):
    """{"fields": {key: [leaf(array)]}, "optimizer": {slot: [leaf(a)] or
    leaf(v)}}: the checkpoint's layout."""
    payload = {"fields": {key: [leaf(a) for a in field_arrays(state.fields[key])] for key in state.fields}}
    if optstate is not None:
        payload["optimizer"] = {
            k: [leaf(a) for a in v] if isinstance(v, (list, tuple)) else leaf(v) for k, v in optstate.items()
        }
    return payload


def checkpoint_save(domain, state, path, optstate=None):
    """Saves state (and optionally optimizer slot variables) to `path`."""
    payload = _payload(state, optstate, _numpy)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _set_fields(domain, state, data, skip_missing, where, keys=None):
    for key in keys or state.fields.keys():
        if key not in data:
            if not skip_missing:
                raise RuntimeError(f"Field {key} not found in {where}")
            continue
        arrays = data[key]
        if not isinstance(arrays, list):
            arrays = [arrays]
        set_field_arrays(state.fields[key], [domain.cast(np.asarray(a)) for a in arrays])


def checkpoint_load(domain, state, path, skip_missing=True, keys=None):
    """Loads fields from a checkpoint into `state` (in place), as tensors on
    the domain's device in its dtype.

    Returns the optimizer slot dict (numpy arrays) if present, else None."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    _set_fields(domain, state, payload.get("fields", dict()), skip_missing, path, keys)
    return payload.get("optimizer")


class AsyncCheckpointer:
    """Asynchronous checkpoints, one numbered directory a step
    (``odil_tpu/checkpoint.py:56``; ``--checkpoint_format orbax``).

    ``save`` copies every field array and optimizer slot into host buffers
    (pinned, ``non_blocking=True`` on the current stream, for tensors on the
    card; a copy at once for host arrays), records a CUDA event and returns:
    the copies are enqueued before any later kernel of the stream, so an
    in-place update that follows (Adam's fused step) does not reach the
    saved step.  A writer thread waits for the event, writes
    ``<directory>/<step>.tmp/state.pickle`` and renames the directory to
    ``<directory>/<step>``, so ``latest_step`` never sees a half-written
    step; with ``max_to_keep`` it then deletes the oldest steps.  Host
    buffers are reused once their step is written."""

    def __init__(self, directory, max_to_keep=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pool = {}  # (shape, dtype) -> free pinned host buffers
        self._lock = threading.Lock()
        self._error = None
        self._queue = queue.Queue()
        self._thread = threading.Thread(target=self._writer, name="odil-checkpoint", daemon=True)
        self._thread.start()

    def _snapshot(self, a, held):
        if not torch.is_tensor(a):
            return np.array(a)
        a = a.detach()
        if not a.is_cuda:
            return a.clone()
        key = (tuple(a.shape), a.dtype)
        with self._lock:
            free = self._pool.get(key)
            host = free.pop() if free else None
        if host is None:
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        host.copy_(a, non_blocking=True)
        held.append(host)
        return host

    def save(self, domain, state, step, optstate=None):
        """Snapshots `state` (and optimizer slots) at `step` and returns; the
        write runs on the writer thread."""
        self._raise()
        held = []
        payload = _payload(state, optstate or None, lambda a: self._snapshot(a, held))
        event = None
        if held:
            event = torch.cuda.Event()
            event.record()
        self._queue.put((int(step), payload, event, held))

    def _writer(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, payload, event, held = item
                if event is not None:
                    event.synchronize()
                self._write(step, _payload_numpy(payload))
                with self._lock:
                    for host in held:
                        self._pool.setdefault((tuple(host.shape), host.dtype), []).append(host)
            except Exception as e:  # raised in the caller's thread by the next save, wait or close
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step, payload):
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "state.pickle"), "wb") as f:
            # Protocol 5 writes each array's buffer as it is, where the default
            # copies it into bytes first with the interpreter lock held: the
            # lock the training loop on the caller's thread needs.
            pickle.dump(payload, f, protocol=5)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self._steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def _steps(self):
        """The whole steps on disk, in order."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def _raise(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"asynchronous checkpoint write failed: {e!r}") from e

    def latest_step(self):
        """The newest step whose directory is whole on disk, or None."""
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, domain, state, step=None, skip_missing=True):
        """Loads fields into `state` in place from `step` (default the latest)
        after the pending saves are written.  Returns the optimizer slot
        dict (numpy arrays) if present, else None."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise RuntimeError("No checkpoint found to restore")
        where = os.path.join(self.directory, str(int(step)), "state.pickle")
        with open(where, "rb") as f:
            payload = pickle.load(f)
        _set_fields(domain, state, payload.get("fields", {}), skip_missing, f"checkpoint step {step}")
        return payload.get("optimizer")

    def wait(self):
        """Blocks until every pending save is whole on disk."""
        self._queue.join()
        self._raise()

    def close(self):
        """Waits for the pending saves and stops the writer thread."""
        if self._thread.is_alive():
            self._queue.join()
            self._queue.put(None)
            self._thread.join()
        self._raise()


def _payload_numpy(payload):
    """The snapshot payload as numpy arrays (bfloat16 as float32)."""
    out = {"fields": {k: [_numpy(a) for a in v] for k, v in payload["fields"].items()}}
    if "optimizer" in payload:
        out["optimizer"] = {
            k: [_numpy(a) for a in v] if isinstance(v, list) else _numpy(v) for k, v in payload["optimizer"].items()
        }
    return out
