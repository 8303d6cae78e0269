"""The benchmark of velesdb_tpu_torch on an NVIDIA H100: the harness
(:mod:`perfbench.harness`, run as ``python3 perfbench/run.py``), its data
generator, the plain reference it judges answers by, the metric readers and
the device's peaks. Nothing here imports JAX or the JAX package.

What belongs to one data model, one operation or one metric sits in a file
of its own, found by name: ``data/<model>.py``, ``ops/<op>.py`` and
``metrics/<metric>.py`` (:func:`load`).
"""

import importlib.util
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``, loaded once."""
    path = HERE / kind / f"{name}.py"
    if not _NAME.match(name) or not path.is_file():
        raise LookupError(f"no perfbench/{kind}/{name}.py")
    key = f"perfbench.{kind}.{re.sub(r'[.-]', '_', name)}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod
