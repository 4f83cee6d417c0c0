"""Command-line flags as a tree of defaults, without absl or ml_collections.

Counterpart of `lwm_tpu/utils/flags.py:19-72` (`define_flags_with_default`
with `ConfigDict` defaults, `flatten_config_dict`, `get_user_flags`). The
defaults are a dict; a value that is itself a dict becomes a group of
dotted flags, `--optimizer.adamw_optimizer.lr=8e-5`, as a `ConfigDict`
default does under absl. Each value is parsed to its default's type (bool,
int, float or str); a `placeholder(type)` default is None until a flag
sets it; a None default takes a Python literal (or the raw string when the
text is not one). A key the defaults do not have is an error, as
`ConfigDict.update` makes it. Spellings: `--name=value`, `--name value`
(not for bools), a bare `--name` for a true bool and `--noname` for a false
top-level one. Groups named in `free` take any key, their values parsed as
literals (the serving CLI's `--llama.<field>`). An error raises
`SystemExit` with a message that names the flag.
"""

from __future__ import annotations

import argparse
import ast
import copy


class placeholder:
    """A None default that a flag sets to a value of `type_`
    (`ml_collections.config_dict.placeholder`)."""

    def __init__(self, type_):
        self.type = type_


def _bool(text):
    low = str(text).lower()
    if low in ("1", "true", "t", "yes", "y"):
        return True
    if low in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"not a bool: {text!r}")


def _literal(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _parse(default, text):
    if isinstance(default, placeholder):
        return default.type(text)
    if isinstance(default, bool):
        return _bool(text)
    if isinstance(default, (int, float, str)):
        return type(default)(text)
    if default is None:
        return _literal(text)
    raise TypeError(f"no parser for a default of type {type(default).__name__}")


def _resolve(tree):
    """The defaults with placeholders as None (a deep copy)."""
    if isinstance(tree, dict):
        return {k: _resolve(v) for k, v in tree.items()}
    return None if isinstance(tree, placeholder) else copy.deepcopy(tree)


def parse_flags(defaults, argv, prog, free=()):
    """`argv` (without the program name) over `defaults` → a namespace of
    the top-level flags, groups as nested dicts."""
    values = _resolve(defaults)
    for name in free:
        values[name] = {}

    def fail(msg):
        raise SystemExit(f"{prog}: {msg}")

    args, i = list(argv), 0
    while i < len(args):
        arg = args[i]
        i += 1
        if not arg.startswith("--"):
            fail(f"unexpected argument {arg!r}")
        key, sep, text = arg[2:].partition("=")
        path = key.split(".")
        if path[0] in free and len(path) == 2:
            if not sep:
                fail(f"--{key} needs a value")
            values[path[0]][path[1]] = _literal(text)
            continue
        node, target = defaults, values
        for part in path[:-1]:
            if not isinstance(node.get(part), dict):
                fail(f"unknown flag --{key}")
            node, target = node[part], target[part]
        leaf = path[-1]
        if leaf not in node:
            if (len(path) == 1 and not sep and leaf.startswith("no")
                    and isinstance(node.get(leaf[2:]), bool)):
                target[leaf[2:]] = False
                continue
            fail(f"unknown flag --{key}")
        default = node[leaf]
        if isinstance(default, dict):
            fail(f"--{key} is a group of flags: set its fields as --{key}.<name>=value")
        if not sep:
            if isinstance(default, bool):
                target[leaf] = True
                continue
            if i == len(args):
                fail(f"--{key} needs a value")
            text = args[i]
            i += 1
        try:
            target[leaf] = _parse(default, text)
        except (ValueError, TypeError) as exc:
            fail(f"--{key}={text}: {exc}")
    return argparse.Namespace(**values)


def flatten_config_dict(config, prefix=None):
    """{a: {b: 1}} → {"a.b": 1}."""
    output = {}
    for key, val in config.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            output.update(flatten_config_dict(val, prefix=name))
        else:
            output[name] = val
    return output


def get_user_flags(flags, defaults):
    """Every flag's value, groups flattened to dotted names: the run's
    `variant`, as the logger and the checkpoint metadata record it."""
    output = {}
    for key in defaults:
        val = getattr(flags, key)
        if isinstance(val, dict):
            output.update(flatten_config_dict(val, prefix=key))
        else:
            output[key] = val
    return output


def merge_config(defaults, updates, name="config"):
    """A deep copy of `defaults` with `updates` (a nested dict or None)
    written over it; a key the defaults do not have raises KeyError, as
    `ConfigDict.update` does (`get_default_config(updates)`)."""
    out = _resolve(defaults)
    for key, value in (updates or {}).items():
        if key not in out:
            raise KeyError(f"unknown {name} option {key!r}")
        out[key] = (merge_config(defaults[key], value, f"{name}.{key}")
                    if isinstance(out[key], dict) else value)
    return out
