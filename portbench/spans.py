"""Spans around the calls into the port's layers, recorded from the
benchmark's own files.

A span is ``(name, start_ns, end_ns)`` on the host's ``perf_counter_ns``
clock and synchronises the card at both ends, so its length is the layer's
time on the card and the host together.  Spans wrap:

* the objective instance's batched sweeps, ``_forward_batch`` (``<layer>.f``)
  and ``_adjoint_batch`` (``<layer>.df``), the calls every solve path makes
  (the host loop reaches them through ``eval_f_``/``eval_df_``);
* the module attributes of the DP kernels' wrappers,
  ``ops/bellman_cuda.dp_build*`` and ``ops/backtrack_cuda.chase*``
  (``dp.build``, ``dp.chase``), which ``ops/bellman.py`` looks up at call
  time.  Each DP call also leaves what its work count needs (the kernel,
  its shapes and its b̃), read once the window has closed.

Spans are recorded only in a traced run.
"""

from __future__ import annotations

import time

DP_WRAPPERS = {
    "bellman_cuda": ("dp_build", "dp_build_batched"),
    "backtrack_cuda": ("chase", "chase_vec", "chase_batched", "chase_trials"),
}


class Recorder:
    def __init__(self, sync):
        self.sync = sync        # the card's synchronise (a no-op in CPU tests)
        self.spans = []         # (name, start_ns, end_ns)
        self.dp_calls = []      # (wrapper name, args) of every DP call
        self._undo = []

    def span(self, name, fn):
        """``fn`` wrapped in a synchronised span named ``name``."""
        spans, sync = self.spans, self.sync

        def inner(*args, **kwargs):
            sync()
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            sync()
            spans.append((name, t0, time.perf_counter_ns()))
            return out

        return inner

    def wrap_sweeps(self, obj, layer: str):
        """Spans ``<layer>.f`` and ``<layer>.df`` on the instance's sweeps."""
        for attr, tag in (("_forward_batch", "f"), ("_adjoint_batch", "df")):
            had = attr in vars(obj)
            old = getattr(obj, attr)
            setattr(obj, attr, self.span(f"{layer}.{tag}", old))
            self._undo.append(lambda o=obj, a=attr, h=had, f=old:
                              setattr(o, a, f) if h else delattr(o, a))

    def wrap_dp(self, modules: dict):
        """Spans ``dp.build`` and ``dp.chase`` on the kernel wrappers in
        ``modules`` (``{"bellman_cuda": module, "backtrack_cuda": module}``).
        A wrapper's launch counter is the function attribute its body
        increments through the module's name, so the span carries it over."""
        for mod_name, names in DP_WRAPPERS.items():
            mod = modules[mod_name]
            for name in names:
                old = getattr(mod, name)
                calls = self.dp_calls
                timed = self.span("dp.build" if mod_name == "bellman_cuda" else "dp.chase", old)

                def inner(*args, _n=name, _t=timed, **kwargs):
                    calls.append((_n, args))
                    return _t(*args, **kwargs)

                inner.launches = getattr(old, "launches", 0)
                setattr(mod, name, inner)
                self._undo.append(lambda m=mod, n=name, f=old, w=inner:
                                  (setattr(f, "launches", w.launches), setattr(m, n, f)))

    def restore(self):
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
