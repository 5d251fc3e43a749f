import sys
import types

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Hypothesis shim: the property tests use hypothesis when it is installed
# (CI installs requirements-dev.txt), but the offline image may not ship it.
# Instead of failing collection, install a stub module whose @given-decorated
# tests skip — every non-property test in the same module still runs.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    class _Strategy:
        """Opaque stand-in for any hypothesis strategy expression."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

        def __repr__(self):
            return "<hypothesis-stub strategy>"

    _ANY = _Strategy()

    def _given(*args, **kwargs):
        def deco(fn):
            def skipper():
                pytest.skip("hypothesis not installed (see "
                            "requirements-dev.txt)")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper
        return deco

    def _settings(*args, **kwargs):
        def deco(fn):
            return fn
        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _ANY
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-second end-to-end runs; deselect with -m 'not slow' "
        "(the fast CI lane)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's kernels); skips "
        "without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
