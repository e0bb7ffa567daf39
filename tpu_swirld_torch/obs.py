"""The per-phase observability scope of the ``Node`` (copy of the
reference's ``tpu_swirld/obs/__init__.py::phase_scope``).

Nothing else of the reference's ``obs`` is ported: ``Metrics``, the tracer,
finality tracking and the flight recorder wait for ROADMAP A9.  A node's
``metrics`` / ``tracer`` fields take any object with the reference's
``phase(name)`` / ``span(name)`` context managers and ``count`` method.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def phase_scope(metrics, tracer, name: str):
    """Combined per-phase scope: times into ``metrics`` and/or spans into
    ``tracer``, either of which may be None."""
    if tracer is not None and metrics is not None:
        with tracer.span(name), metrics.phase(name):
            yield
    elif tracer is not None:
        with tracer.span(name):
            yield
    elif metrics is not None:
        with metrics.phase(name):
            yield
    else:
        yield
