"""Finds the benchmark's parts by name, so that a later change adds a
cell, a configuration, a traffic mix, a loop or a per-layer metric as new
files and edits none:

  cells/<cell>.json        configuration, traffic, loop, chips, why, the
                           metrics the cell reports and its limits
  configs/<config>.json    the scene, its source, reduced and assumed keys
  traffic/<traffic>.json   the parameters the general generator reads
  loops/<loop>.py          how a window drives the port
  metrics/<metric>.py      how a per-layer metric is read from a traced run
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODULES: dict = {}


def path(kind: str, name: str, ext: str) -> str:
    return os.path.join(ROOT, kind, name + ext)


def load_json(kind: str, name: str) -> dict:
    p = path(kind, name, ".json")
    if not os.path.isfile(p):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({p})")
    with open(p) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module loops/<name>.py or metrics/<name>.py (names may hold
    dots), loaded once a process."""
    key = (kind, name)
    if key not in _MODULES:
        p = path(kind, name, ".py")
        if not os.path.isfile(p):
            raise KeyError(f"no {kind[:-1]} named {name!r} ({p})")
        mod_name = f"bench_port_{kind}_" + name.replace(".", "_")
        spec = importlib.util.spec_from_file_location(mod_name, p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def names(kind: str, ext: str) -> list:
    d = os.path.join(ROOT, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d) if f.endswith(ext))


def cell(name: str) -> dict:
    """The cell with its configuration and traffic loaded beside it."""
    c = dict(load_json("cells", name))
    c["name"] = name
    c["config_data"] = load_json("configs", c["config"])
    c["traffic_data"] = load_json("traffic", c["traffic"])
    return c
