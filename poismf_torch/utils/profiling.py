"""Profiling helpers: the program's spans and host-sync counter, a
``torch.profiler`` trace of a block with them, and a per-epoch callback
for the alternating drivers.

Counterpart of ``poismf_tpu/utils/profiling.py`` (an XLA profiler trace
and the same callback).

Spans and host syncs are recorded while :data:`SPANS` holds a
:class:`Recorder` (``None``, the default, records nothing):

* :func:`span` marks a stretch of host code by name.  The text before the
  first dot is the layer: ``fit``, ``half.*`` (driver), ``ell.*`` (plane
  gather, ELL build), ``cascade.*`` (the cascade's rounds, host decisions
  and compact builds), ``solver.*`` (the solvers' loops), ``topn*``
  (serving), ``ingest``.  Each span keeps its start and end on
  ``time.time_ns()``, the clock ``torch.profiler`` puts its host and
  device events on, the span open around it when it started (its parent)
  and the outermost such span (its root: one fit, one request).
* :func:`host` (a device-to-host read) and :func:`to_device` (a copy from
  the host, which waits for the card too) count each blocking transfer by
  its site and add up the host seconds it blocked.

Nothing is written while a fit or a request runs: the recorder keeps
everything in memory until its caller reads it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch


class Span:
    """One recorded span: ``name``, ``start_ns`` and ``end_ns`` on
    ``time.time_ns()`` (``end_ns`` None while open), and the indices in
    :attr:`Recorder.spans` of its ``parent`` (None for a root) and of its
    ``root`` (itself for a root)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "root")

    def __init__(self, name: str, start_ns: int, parent: Optional[int],
                 root: int):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.root = parent, root


class Recorder:
    """What one recording holds: ``spans`` in the order they opened, and
    ``syncs``, per site ``[count, blocked seconds]``."""

    def __init__(self):
        self.spans: List[Span] = []
        self.syncs: Dict[str, list] = {}
        self._open: List[int] = []

    def open(self, name: str) -> None:
        i = len(self.spans)
        parent = self._open[-1] if self._open else None
        root = i if parent is None else self.spans[parent].root
        self.spans.append(Span(name, time.time_ns(), parent, root))
        self._open.append(i)

    def close(self) -> None:
        # spans are ``with`` blocks: the one to close is the innermost
        self.spans[self._open.pop()].end_ns = time.time_ns()

    def count(self, site: str, blocked_ns: int) -> None:
        c = self.syncs.get(site)
        if c is None:
            c = self.syncs[site] = [0, 0.0]
        c[0] += 1
        c[1] += blocked_ns * 1e-9

    @property
    def n_syncs(self) -> int:
        return sum(c for c, _ in self.syncs.values())

    def chrome_events(self, base_ns: int, pid: int) -> list:
        """The (closed) spans as Chrome trace complete events on a track
        of their own (``ts`` in microseconds after ``base_ns``), and the
        host syncs by site as the arguments of one instant event at the
        last span's end."""
        tid = 0
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": "poismf spans"}}]
        last = base_ns
        for i, s in enumerate(self.spans):
            last = max(last, s.end_ns)
            out.append({"ph": "X", "cat": "poismf_span", "name": s.name,
                        "pid": pid, "tid": tid,
                        "ts": (s.start_ns - base_ns) / 1e3,
                        "dur": (s.end_ns - s.start_ns) / 1e3,
                        "args": {"index": i, "parent": s.parent,
                                 "root": s.root}})
        out.append({"ph": "i", "s": "t", "cat": "poismf_host_syncs",
                    "name": "host syncs", "pid": pid, "tid": tid,
                    "ts": (last - base_ns) / 1e3,
                    "args": {site: {"count": c, "seconds": s}
                             for site, (c, s) in self.syncs.items()}})
        return out


# The recorder that spans and host syncs go to; None records nothing.
SPANS: Optional[Recorder] = None


class _Open:
    __slots__ = ("rec", "name")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec.open(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.close()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """``with span(name): ...`` records the block as a span of
    :data:`SPANS`; with no recorder, a shared object that does
    nothing."""
    rec = SPANS
    if rec is None:
        return _OFF
    return _Open(rec, name)


def host(x, site: str):
    """``x.cpu()``, the blocking device-to-host read of ``x`` (a no-op on
    the CPU), counted under ``site`` with the seconds it blocked."""
    rec = SPANS
    if rec is None:
        return x.cpu()
    t = time.time_ns()
    out = x.cpu()
    rec.count(site, time.time_ns() - t)
    return out


def host_any(mask, site: str) -> bool:
    """A loop test: whether any entry of ``mask`` is set, read on the host
    by :func:`host` (one sync, counted under ``site``)."""
    return bool(host(mask.any(), site))


def to_device(x, device, site: str):
    """``torch.as_tensor(x).to(device)`` (``x`` a NumPy array or a host
    tensor): the copy to the card, which waits for the card's queue
    first, counted under ``site`` as :func:`host` counts a read."""
    rec = SPANS
    if rec is None:
        return torch.as_tensor(x).to(device)
    t = time.time_ns()
    out = torch.as_tensor(x).to(device)
    rec.count(site, time.time_ns() - t)
    return out


@contextlib.contextmanager
def trace(path: str):
    """Record a ``torch.profiler`` trace of the enclosed block (CPU
    activity, and the card's where there is one) with the program's
    spans and host syncs (:data:`SPANS` holds a fresh :class:`Recorder`
    over the block), and write it as a Chrome trace (Perfetto,
    chrome://tracing) to ``path``::

        with profiling.trace("fit_trace.json"):
            model.fit(df)

    The spans are complete events (category ``poismf_span``) on a
    ``poismf spans`` track of the process, on the same timeline as the
    profiler's host and device events; the host syncs by site, ``{site:
    {"count", "seconds"}}``, are the arguments of a ``host syncs`` instant
    event (category ``poismf_host_syncs``)."""
    from torch.profiler import ProfilerActivity, profile

    global SPANS
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prev, rec = SPANS, Recorder()
    SPANS = rec
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        SPANS = prev
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(rec.chrome_events(
        int(doc.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)


def epoch_logger(
    by_user=None,
    every: int = 1,
    printer: Callable[[str], None] = print,
) -> Callable:
    """A ``callback`` for :func:`poismf_torch.train.run_poismf` and
    :func:`poismf_torch.parallel.mesh.run_poismf_sharded` that reports
    per-epoch wall time (waiting for the card's queued work first) and,
    when ``by_user`` is given every ``every`` epochs, the training Poisson
    LL (one pass over the nonzeros)."""
    state = {"t": time.time()}

    def cb(epoch, A, B):
        if A.is_cuda:
            torch.cuda.synchronize(A.device)
        now = time.time()
        msg = f"[poismf] epoch {epoch}: {now - state['t']:.2f}s"
        if by_user is not None and epoch % every == 0:
            from ..ops.objective import eval_llk

            msg += f"  train_llk={float(eval_llk(A, B, by_user)):.6g}"
        state["t"] = time.time()
        printer(msg)

    return cb
