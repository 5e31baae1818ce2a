"""Test-env portability: run the property suites without ``hypothesis``.

When the real ``hypothesis`` package is importable this file does nothing.
When it is absent (clean container), a minimal stand-in module is installed
into ``sys.modules`` *before* test collection so ``from hypothesis import
given, settings, strategies as st`` keeps working.  The stand-in replays a
small, fixed, deterministic set of example inputs per test (seeded by the
test name), trading hypothesis' search for reproducible smoke coverage of
the same properties.

Only the strategy combinators this repo uses are implemented:
``integers``, ``sampled_from`` and ``lists``.
"""
from __future__ import annotations

import functools
import inspect
import random
import sys
import types
import zlib

try:
    import hypothesis  # noqa: F401  (real package wins when available)
except ImportError:
    _N_EXAMPLES = 5  # fixed replay count per property test

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example(self, rng: random.Random):
            return self._draw(rng)

    def _integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rng: rng.choice(elements))

    def _lists(elements, min_size=0, max_size=10):
        return _Strategy(lambda rng: [
            elements.example(rng)
            for _ in range(rng.randint(min_size, max_size))])

    def _given(*arg_strategies, **kw_strategies):
        def decorate(test):
            @functools.wraps(test)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_shim_max_examples", _N_EXAMPLES)
                n = min(n, _N_EXAMPLES)
                seed = zlib.crc32(test.__qualname__.encode())
                for i in range(n):
                    rng = random.Random(seed + i)
                    drawn_args = tuple(s.example(rng) for s in arg_strategies)
                    drawn_kw = {k: s.example(rng)
                                for k, s in kw_strategies.items()}
                    test(*args, *drawn_args, **{**drawn_kw, **kwargs})

            # pytest must not mistake the drawn parameters for fixtures:
            # hide the wrapped signature (hypothesis does the same).
            wrapper.__signature__ = inspect.Signature()
            del wrapper.__wrapped__
            wrapper.hypothesis_shim = True
            return wrapper
        return decorate

    def _settings(max_examples=None, deadline=None, **_ignored):
        def decorate(test):
            if max_examples is not None and hasattr(test, "hypothesis_shim"):
                test._shim_max_examples = max_examples
            return test
        return decorate

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _st.lists = _lists

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(all=staticmethod(lambda: []))
    _hyp.__is_shim__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")
