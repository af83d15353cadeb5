"""Spans inside the program, off by default.

    from mioc_tpu_torch.utils import trace
    trace.enable()
    ...                                   # solves
    spans = trace.take()                  # the spans so far, then cleared
    trace.disable()

A span (:class:`Span`) is one named interval of the host's work: ``id``,
``parent`` (the id of the span that was open when it opened, or ``None``),
``call`` (the id of the outermost open span, the root ``solve`` span of a
request; a root's own id), ``name``, ``t0_ns``/``t1_ns`` on
``time.perf_counter_ns()`` and a small dict of attributes.  The records stay
in memory until :func:`take`; nothing is written out.

A span stamps the host's clock only: it never synchronises the card and never
reads a tensor, and its attributes are values the host already holds
(shapes and counts).  So a span around queued work measures the enqueue,
and a span around a host read measures the wait for the card.  Spans open
where the work happens, never once per time step: a sweep's step count is an
attribute of its span.

Off (the default), :func:`span` returns one shared no-op context: nothing is
recorded.

The spans the program opens (``<layer>`` is ``ode_sweep``, ``pde_sweep`` or
``conv_sweep``):

========================  ============================================  ==============================
span                      where                                         attributes
========================  ============================================  ==============================
``solve``                 ``trm_solve``, ``trm_solve_device``,          at its end Σ ``f_evals``,
                          ``multistart_solve_device``                   Σ ``df_evals``
``trm.outer``             one outer TRM iteration
``trm.read``              a host read that ends a loop of the device    ``what``
                          TRM, or the result's copy back
``trm.stage``             ``stage_tables``
``trm.tv``                the device loop's ``tv_rows``/``iv_rows``
``<layer>.f``,            an objective's ``_forward_batch``,            ``rows``, ``rows_swept``
``<layer>.df``            ``_adjoint_batch``                            (padding included), ``steps``,
                                                                        ``path``: ``"kernel"`` where
                                                                        one hand-written launch
                                                                        computed the recursion
                                                                        (``ops/ode_cuda.py``,
                                                                        ``ops/pde_cuda.py``), set where
                                                                        the objective dispatches, else
                                                                        ``"torch"``
``dp.build``              the build dispatchers of ``ops/bellman.py``   on the card ``ctas``: the CTAs
                                                                        of a start (1: one block), set
                                                                        by the launch
                                                                        (``ops/bellman_cuda.py``)
``dp.chase``              the chase dispatchers of ``ops/bellman.py``
========================  ============================================  ==============================
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Span", "enable", "disable", "enabled", "span", "annotate", "take"]


@dataclass(slots=True)
class Span:
    id: int
    parent: Optional[int]
    call: int
    name: str
    t0_ns: int
    t1_ns: Optional[int] = None     # None while the span is open
    attrs: dict = field(default_factory=dict)


class _Off:
    """The span of a disabled recorder: one shared object that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans = []
        self.stack = []
        self.next_id = 0


_REC = _Recorder()


class _Open:
    """An enabled span: stamps the clock on entry and exit."""

    __slots__ = ("span",)

    def __init__(self, name, attrs):
        self.span = Span(0, None, 0, name, 0, None, attrs)

    def __enter__(self):
        rec, s = _REC, self.span
        top = rec.stack[-1] if rec.stack else None
        s.id = rec.next_id
        rec.next_id += 1
        s.parent = None if top is None else top.id
        s.call = s.id if top is None else top.call
        rec.spans.append(s)
        rec.stack.append(s)
        s.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.span.t1_ns = time.perf_counter_ns()
        _REC.stack.pop()
        return False

    def set(self, **attrs):
        """Add attributes, such as counts known only at the span's end."""
        self.span.attrs.update(attrs)


def enable() -> None:
    _REC.on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`take`."""
    _REC.on = False


def enabled() -> bool:
    return _REC.on


def span(name: str, **attrs):
    """A context manager over one span named ``name``; ``with span(...) as
    s: ... s.set(k=v)`` adds attributes before it closes."""
    if not _REC.on:
        return _OFF
    return _Open(name, attrs)


def annotate(**attrs) -> None:
    """Add attributes to the innermost open span, where one is recording:
    for a count that a callee knows, such as the CTAs a build launched."""
    if _REC.on and _REC.stack:
        _REC.stack[-1].attrs.update(attrs)


def take() -> list:
    """The spans recorded so far, in the order they opened; clears them.  A
    span still open is returned with ``t1_ns`` None."""
    spans, _REC.spans = _REC.spans, []
    return spans
