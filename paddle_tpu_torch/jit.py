"""The trace flag of the JAX package's jit (counterpart of ``in_jit_trace``
and ``_tracing`` in paddle_tpu/jit/__init__.py).

The JAX package runs its train step, ``generate`` and the serving engine's
dispatches as traced programs, and code that keeps state on the host asks
``in_jit_trace()`` to leave it alone there: QATLinear's moving-average
activation scale (incubate/quantization.py) moves only in eager calls. The
port runs those calls eagerly, so it enters ``_tracing()`` at the same
places (``TrainStepEngine._forward``, ``GPTForPretraining.generate`` and
``generate_beam``, every ServingEngine dispatch), and such state moves
exactly where the JAX package's does. ``trace_scope(flag)`` re-enters a
flag read earlier: a recomputed segment replays in the backward under its
forward's flag, as the JAX package's replay runs inside the traced step.
Nothing is compiled; ``to_static`` and the rest of that module are not
ported.
"""
from __future__ import annotations

import contextlib
import threading

_trace_state = threading.local()


def in_jit_trace() -> bool:
    return getattr(_trace_state, "tracing", False)


@contextlib.contextmanager
def trace_scope(flag: bool):
    """Set this thread's trace flag to ``flag`` for the block and restore
    the one before."""
    prev = in_jit_trace()
    _trace_state.tracing = bool(flag)
    try:
        yield
    finally:
        _trace_state.tracing = prev


def _tracing():
    return trace_scope(True)
