"""Find a part of the benchmark by its name: ``<kind>/<name>.py``.

Every part that belongs to one configuration, traffic mix or metric is a
file of its own, loaded by the name that ``BENCHMARK.json``, a
configuration or a traffic mix gives it, so that a later change adds a
part as a new file and edits none:

* ``systems/<config["system"]>.py``: the program's entry that a cell drives;
* ``reference/<config["reference"]>.py``: its plain reference;
* ``functions/<config["function"]>.py``: the field sampled at the sites;
* ``distributions/<name>.py``: how sites or queries are spread;
* ``loops/<traffic["loop"]>.py``: how the requests are offered;
* ``metrics/<metric>.py``: a metric's reader.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


@functools.cache
def find(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"benchmark: no {kind} part named {name!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def exists(kind: str, name: str) -> bool:
    return (HERE / kind / f"{name}.py").is_file()
