"""Architectures, each a pair of files found by the name a configuration
file gives under ``arch`` (``llama`` where it gives none):

* ``servebench/archs/<name>.py``, what the harness needs to run it:
  ``shape(raw)``, the sizes from the configuration's keys;
  ``layout(shape, dtype)``, the weights' tree of ``(shape, dtype, std)``
  leaves, in the port's parameter tree (``servebench/weights.py`` fills
  it); ``port_config(raw, dtype)``, the port's ``ModelConfig``, importing
  the port only when called; ``count(shape, parts, lengths, table_cols)``,
  an iteration's kernel calls as ``(kind, flops, bytes)`` and last its
  model FLOPs as ``("step", flops, 0.0)``; ``vocab(raw)``, the vocabulary
  prompts are drawn from; and ``TINY``, configurations small enough for
  the CPU tests;
* ``servebench/reference/<name>.py``, the plain f32 reference with its
  e4m3 control, which imports nothing of the port: ``arch(raw)``, its
  sizes, and ``logits(params, arch, seqs, firsts, precision="f32",
  margins=None)``.

The two stay apart because the reference may not import the port, and
``port_config`` must. A later architecture is two new files, which may
import ``llama``'s helpers; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REFERENCE = HERE.parent / "reference"
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _load(where: Path, package: str, name: str):
    """The module ``<where>/<name>.py`` under the name ``<package>.<name>``,
    loaded once (a normal import of the same file shares it)."""
    if not NAME.match(name):
        raise ValueError(f"not an architecture's name: {name!r}")
    path = (where / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no architecture {name!r} ({path})")
    key = f"{package}.{name}"
    mod = sys.modules.get(key)
    if mod is not None and Path(mod.__file__).resolve() == path:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def harness(name: str):
    """``servebench/archs/<name>.py``."""
    return _load(HERE, "servebench.archs", name)


def reference(name: str):
    """``servebench/reference/<name>.py``."""
    return _load(REFERENCE, "servebench.reference", name)


def names() -> list:
    """Every architecture in ``servebench/archs/``."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")
