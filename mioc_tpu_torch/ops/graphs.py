"""CUDA graphs of an objective's per-step sweeps: one capture per input
shape, replayed on every later call.

A per-step sweep issues ~10⁴ small kernels, and issued one by one from the
host each costs several µs of host time against ~1 µs on the card: the sweep
runs at the host's speed and the card idles.  Captured once as a CUDA graph
and replayed, the same kernels run back to back on the card from one host
call, so the sweep's time is the card's.  The replay launches the captured
kernels on the same operands, so it has the eager sweep's bits.

:class:`SweepGraphs` keeps one objective's graphs.  The first call at a shape
runs the sweep as written (its answer, and the warm-up that the capture
needs: one-time host reads such as ``xla_order.addcmul_fuses`` happen there,
not under capture), then captures it.  A later call copies its inputs into
the captured ones, replays, and returns copies of the outputs, so no caller
holds memory that the next replay overwrites.  On the CPU the sweep runs as
written.  A captured function must be free of host reads and of copies from
the host (a ``torch.tensor(…, device=…)``): a capture refuses both.
"""

from __future__ import annotations

import torch

__all__ = ["SweepGraphs"]


class SweepGraphs:
    """The CUDA graphs of one objective's sweeps, one per function, ``key``
    and shapes of the tensor arguments."""

    def __init__(self):
        self._graphs = {}

    def __len__(self):
        return len(self._graphs)

    def __call__(self, fn, *args, key=()):
        """``fn(*args)`` (a tuple of tensors), replayed from a graph on the
        card; ``key`` names whatever else the captured work depends on."""
        if not args[0].is_cuda:
            return fn(*args)
        k = (fn.__name__, key, *((a.shape, a.dtype, a.device) for a in args))
        graph = self._graphs.get(k)
        if graph is None:
            out = fn(*args)
            self._graphs[k] = _capture(fn, args)
            return out
        ins, outs, g = graph
        for buf, a in zip(ins, args):
            buf.copy_(a)
        g.replay()
        return tuple(o.clone() for o in outs)


def _capture(fn, args):
    ins = tuple(a.clone() for a in args)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.device(args[0].device), torch.cuda.graph(g):
        outs = fn(*ins)
    return ins, outs, g
