"""File-cache decorator: memoize a function's result to disk by extension.

Counterpart of reference ``src/odil/cache.py``: ``@cache_to_file(path)``
stores the wrapped function's return value in pickle / json / npy format
(chosen by extension) and short-circuits future calls.

The port's own copy of ``odil_tpu/cache.py`` (numpy only).
"""

import functools
import json
import os
import pickle

import numpy as np

__all__ = ["cache_to_file"]


def _load(path):
    ext = os.path.splitext(path)[1]
    if ext == ".pickle":
        with open(path, "rb") as f:
            return pickle.load(f)
    if ext == ".json":
        with open(path) as f:
            return json.load(f)
    if ext == ".npy":
        return np.load(path, allow_pickle=True)
    raise ValueError(f"Unknown cache extension '{ext}'")


def _store(path, value):
    ext = os.path.splitext(path)[1]
    if ext == ".pickle":
        with open(path, "wb") as f:
            pickle.dump(value, f)
    elif ext == ".json":
        with open(path, "w") as f:
            json.dump(value, f)
    elif ext == ".npy":
        np.save(path, value)
    else:
        raise ValueError(f"Unknown cache extension '{ext}'")


def cache_to_file(path, arg0_key=False, update=False, verbose=False):
    """Decorator caching the function result at `path`.

    arg0_key: include the first positional argument in the file name.
    update: recompute and overwrite even if the cache exists.
    """

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            target = path
            if arg0_key and args:
                base, ext = os.path.splitext(path)
                target = f"{base}_{args[0]}{ext}"
            if not update and os.path.isfile(target):
                if verbose:
                    print(f"Loading cache '{target}'")
                return _load(target)
            value = func(*args, **kwargs)
            if verbose:
                print(f"Writing cache '{target}'")
            _store(target, value)
            return value

        return wrapper

    return decorator
