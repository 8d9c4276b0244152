"""The port stands alone: it imports neither JAX nor the ``repro``
package, and its entry points default to the card."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any import of these now raises
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default is usable")
    from repro_torch.index import ivf
    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    with pytest.raises((AssertionError, RuntimeError)):
        ivf.build(x, nlist=4)
    ivf.build(x, nlist=4, device="cpu")  # the CPU when asked for
