"""Profiling helpers: a ``torch.profiler`` trace of a block, and a
per-epoch callback for the alternating drivers.

Counterpart of ``poismf_tpu/utils/profiling.py`` (an XLA profiler trace
and the same callback).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable


@contextlib.contextmanager
def trace(path: str):
    """Record a ``torch.profiler`` trace of the enclosed block (CPU
    activity, and the card's where there is one) and write it as a
    Chrome trace (Perfetto, chrome://tracing) to ``path``::

        with profiling.trace("fit_trace.json"):
            model.fit(df)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


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
        import torch

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
