"""File IO of the trainer on local paths (`lwm_tpu/utils/io.py:14-47`).

The JAX package reads `gs://` paths through gcsfs; the port runs where
gcsfs is not installed, so such a path raises `NotImplementedError`.

`load_pickle` unpickles with a restricted `Unpickler`: the trainer reads
back only the dataset states it (or the JAX trainer) wrote, and those hold
plain dicts, numbers and strings, except that the JAX trainer pickles its
dataset config as an `ml_collections.ConfigDict` (`lwm_tpu/data/text.py:
446-452`). ml_collections is not a dependency of the port, so its
`ConfigDict` and `FieldReference` load as plain dicts and values; any other
global raises `pickle.UnpicklingError`.
"""

from __future__ import annotations

import builtins
import os
import pickle


def _local(path):
    if isinstance(path, str) and path.startswith("gs://"):
        raise NotImplementedError(
            f"{path}: gs:// paths need gcsfs, which the port does not use; copy the file to a "
            "local path"
        )
    return path


def open_file(path, mode="rb"):
    return open(_local(path), mode)


def makedirs(path, exist_ok=True):
    os.makedirs(_local(path), exist_ok=exist_ok)


def check_exists(path):
    return os.path.exists(_local(path))


def save_pickle(obj, path):
    with open_file(path, "wb") as fout:
        pickle.dump(obj, fout)


class _ConfigDict(dict):
    """What a pickled `ml_collections.ConfigDict` loads as: its fields."""

    def __setstate__(self, state):
        self.update(state["_fields"])


class _FieldReference:
    """What a pickled `ml_collections.FieldReference` loads as, until
    `_plain` replaces it by its value."""

    def __setstate__(self, state):
        self.value = state["_value"]


_ML_COLLECTIONS = {"ConfigDict": _ConfigDict, "FieldReference": _FieldReference}
_BUILTINS = ("str", "int", "float", "bool")   # a FieldReference's field type


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("ml_collections.") and name in _ML_COLLECTIONS:
            return _ML_COLLECTIONS[name]
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")


def _plain(obj):
    """ConfigDict stubs → dicts and FieldReferences → their values, nested."""
    if isinstance(obj, _FieldReference):
        return _plain(obj.value)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def load_pickle(path):
    with open_file(path, "rb") as fin:
        return _plain(_Unpickler(fin).load())
