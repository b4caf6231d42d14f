"""Test-suite bootstrap.

* Makes ``src/`` importable so ``pytest`` works without PYTHONPATH set.
* Installs the offline :mod:`_hyp` shim as ``hypothesis`` when the real
  package is absent (this environment cannot install it); the property
  tests then run over a fixed deterministic example set.  A real
  ``hypothesis`` install is used untouched.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "src"))

try:
    import hypothesis  # noqa: F401  (real package wins when available)
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    from _hyp import install_shim

    install_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a "
                   "CUDA device (run on the card: python -m pytest -m cuda "
                   "tests/test_torch_*.py)")
