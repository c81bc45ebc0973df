"""Faults planted under the timed call, for the tests that must see
``correct`` come out false and for the readings that set a limit's upper
end.  ``make(kind, name)`` returns a function that wraps the timed call,
as the traffic kind's module says (its ``FAULTS`` and ``fault``); the
wrappers of the fit and top-N kinds are here (:func:`fit`, :func:`topn`):

* ``unchanged``: the call hands back its state unchanged (a fit returns
  its init);
* ``half``: half of the batch left out (every other row of a fit keeps
  its init; the second half of a top-N batch gets the first half's
  lists);
* ``altered``: an answer altered where it is produced (every 64th row of
  a fit scaled by 1.5; the first item of every 16th list moved to the
  next id);
* ``unchanged.users``, ``half.users``: the same in a fit's last user
  half alone (its rows, or every other one, keep the state the half
  started from), the item halves untouched.

A fit's user-half faults touch nothing but the fit's returned user rows,
so :func:`users_only` also plants them on a sound run's answers, and
``altered.users`` (every 64th user row scaled by 1.5) besides, for its
reading: no compared number catches it (see PERF.md).
"""

from __future__ import annotations

import numpy as np

from . import kinds


def users_only(name, A, A_start):
    """The user rows ``A`` of a fit whose last user half, started from
    ``A_start``, has the fault ``name``."""
    if name == "unchanged.users":
        return A_start.clone()
    A = A.clone()
    if name == "half.users":
        A[::2] = A_start[::2]
    elif name == "altered.users":
        A[::64] *= 1.5
    else:
        raise ValueError(f"no user-half fault {name!r}")
    return A


def fit(name):
    """The wrapper of ``train.run_poismf`` that plants the fit fault
    ``name``."""
    def wrap(fn):
        def call(A0, B0, by_user, by_item, p, callback=None):
            if name == "unchanged":
                return A0.clone(), B0.clone(), 0
            seen = [A0]

            def each_epoch(epoch, A, B):
                seen.append(A)
                if callback is not None:
                    callback(epoch, A, B)

            A, B, status = fn(A0, B0, by_user, by_item, p,
                              callback=each_epoch)
            if name.endswith(".users"):
                return users_only(name, A, seen[-2]), B, status
            A, B = A.clone(), B.clone()
            if name == "half":
                A[::2], B[::2] = A0[::2], B0[::2]
            elif name == "altered":
                A[::64] *= 1.5
                B[::64] *= 1.5
            return A, B, status
        return call
    return wrap


def _shift_first(ids, every, n_items):
    ids = np.array(ids, copy=True)
    ids[::every, 0] = (ids[::every, 0] + 1) % n_items
    return ids


def topn(name):
    """The wrapper of ``PoisMF.topN_batched`` that plants the top-N fault
    ``name``."""
    def wrap(fn):
        model = fn.__self__

        def call(users, n=10, exclude_seen=True):
            if name == "half":
                h = (users.shape[0] + 1) // 2
                first = fn(users[:h], n=n, exclude_seen=exclude_seen)
                return np.concatenate([first, first[:users.shape[0] - h]])
            ids = fn(users, n=n, exclude_seen=exclude_seen)
            if name == "altered":
                return _shift_first(ids, 16, model.nitems)
            raise ValueError(f"no top-N fault {name!r}")
        return call
    return wrap


def make(kind: str, name: str):
    """The wrapper of the kind ``kind``'s timed call that plants its fault
    ``name``."""
    mod = kinds.load(kind)
    if name not in mod.FAULTS:
        raise ValueError(f"no {kind} fault {name!r}")
    return mod.fault(name)
