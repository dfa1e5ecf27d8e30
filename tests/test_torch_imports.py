"""``repro_torch`` stands alone: importing it and every submodule pulls in
neither JAX nor the reference package, and no source names them in an
import.  ``chip_smoke.py`` obeys the same rule."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)", re.M)


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return files


def _modules():
    import repro_torch

    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_every_submodule_imports_alone_without_jax_or_repro():
    """Each submodule in a fresh interpreter (so an import cycle that one
    order hides still shows), a few at a time."""
    code = ("import importlib, sys\n"
            "importlib.import_module(sys.argv[1])\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    mods = _modules()
    assert len(mods) >= 20
    failed = []
    for lo in range(0, len(mods), 6):
        procs = [(m, subprocess.Popen([sys.executable, "-c", code, m],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
                 for m in mods[lo:lo + 6]]
        for m, proc in procs:
            _, err = proc.communicate(timeout=120)
            if proc.returncode:
                failed.append(f"{m}: {err.strip().splitlines()[-1]}")
    assert not failed, failed


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_neither_jax_nor_repro(path):
    with open(path) as f:
        text = f.read()
    assert not FORBIDDEN.search(text), path
