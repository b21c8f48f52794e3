"""The benchmark's parts, found by name.

A part of kind K named N is the file benchmark/K/N.py (scenes, paths,
entries, loops, reference, metrics), or benchmark/K/N.json for data
(configs, traffic, checks). Nothing in the harness names one: a later
cell, path, entry point, loop, reference or metric is a file added here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def load_json(path):
    with open(path) as f:
        return json.load(f)


def data(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json."""
    return load_json(BENCH / kind / f"{name}.json")


def exists(kind: str, name: str) -> bool:
    return (BENCH / kind / f"{name}.py").is_file()


def load(kind: str, name: str):
    """The module benchmark/<kind>/<name>.py, loaded once a process, as
    benchmark.<kind>.<name> (so a reference's relative imports hold)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} part {name!r}: {path}")
    modname = f"benchmark.{kind}.{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod
