"""User-facing ``PoisMF`` class of the PyTorch port.

Same constructor arguments as ``poismf_tpu.PoisMF`` plus ``device``; the
same "auto" hyperparameter tables, reindexing and method surface:
``fit`` and ``fit_unsafe`` with methods "tncg", "cg" and "pg", ``A`` /
``B``, ``predict``, ``topN``, ``topN_batched`` (with ``exclude_seen``),
``topN_new``, ``predict_factors``, ``transform``, ``eval_llk`` and
``save`` / ``load``.  A ``mesh`` (a one-dimensional
``torch.distributed`` DeviceMesh, one process a device) fits row-sharded
(:mod:`poismf_torch.parallel`): every rank calls ``fit`` with the same
data and parameters and ends with the whole of A and B.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import serve, train
from ..ops import objective as obj
from ..sparse import (CountsMatrix, IngestResult, build_counts, csr_like,
                      ingest)
from ..train import FitParams
from ..utils import profiling

__all__ = ["PoisMF"]

# predict() sends pair lists longer than this to the device one chunk at
# a time (bounded device memory: two [chunk, k] gathers at a time)
PREDICT_CHUNK = 4_194_304


def _as_1d(x):
    return np.require(x, requirements=["ENSUREARRAY"]).reshape(-1)


def resolve_device(device, mesh=None) -> torch.device:
    """The device a model runs on: the one the caller states, else the
    mesh's (:func:`poismf_torch.parallel.mesh.mesh_device`), else "cuda".
    "cuda" without a usable card raises, and so does a device that
    contradicts the mesh: nothing is moved or falls back silently."""
    if mesh is not None:
        from ..parallel.mesh import mesh_device

        dev = mesh_device(mesh)
        want = dev if device is None else torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"device={device!r} contradicts the mesh, "
                             f"whose device on this rank is {dev}")
        return dev
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


class PoisMF:
    """Non-Bayesian Poisson factorization of sparse counts (PyTorch).

    Parameters mirror ``poismf_tpu.PoisMF`` (k, method, l2_reg, l1_reg,
    niter, maxupd, limit_step, initial_step, early_stop, reuse_prev,
    weight_mult, random_state, reindex, copy_data, produce_dicts,
    use_float, handle_interrupt, nthreads, n_jobs, mesh, nnz_chunk,
    layout, plane_dtype, max_cg); nthreads and n_jobs, which no path of
    the port reads, are kept for checkpoint compatibility.  ``layout`` is
    "auto" or "ell" (the planar ELL, whose sweeps on the card are the
    hand-written kernels) or "coo" (the flat COO stream, gathers and
    segment sums, as the JAX package's; tncg then runs without the
    cascade, with the reference inner-CG cap unless ``max_cg`` is given).
    ``nnz_chunk`` makes every COO evaluation walk the stream in chunks of
    that many entries (it must divide the padded nnz, a multiple of 1024),
    which bounds its ``[chunk, k]`` intermediates.  ``mesh`` is a
    one-dimensional DeviceMesh (:func:`poismf_torch.parallel.mesh.make_mesh`)
    or None.  ``device`` ("cuda" by default; the mesh's device with a
    mesh; or "cpu") is where the factors live and the fit runs; CUDA
    tensors go through the hand-written kernels, CPU tensors through their
    plain PyTorch versions.  ``use_float=False`` keeps the factors in
    float64 on either device, and each ELL sweep then takes the JAX
    package's x64 route (:mod:`poismf_torch.ops.ell`): the plane kernels
    on float32 casts where the planes are bf16 or float32, the plain
    versions in float64 for the ray searches and for float64 planes."""

    def __init__(self, k=50, method="tncg",
                 l2_reg="auto", l1_reg=0.0,
                 niter="auto", maxupd="auto",
                 limit_step=True, initial_step=1e-7,
                 early_stop=True, reuse_prev=False,
                 weight_mult=1.0, random_state=1,
                 reindex=True, copy_data=True, produce_dicts=False,
                 use_float=True, handle_interrupt=True,
                 nthreads=-1, n_jobs=None,
                 mesh=None, nnz_chunk=None, layout="auto",
                 plane_dtype=None, max_cg="auto", device=None):
        self.k = k
        self.method = method
        self.l2_reg = l2_reg
        self.l1_reg = l1_reg
        self.niter = niter
        self.maxupd = maxupd
        self.limit_step = limit_step
        self.initial_step = initial_step
        self.early_stop = early_stop
        self.reuse_prev = reuse_prev
        self.weight_mult = weight_mult
        self.random_state = random_state
        self.reindex = reindex
        self.copy_data = copy_data
        self.produce_dicts = produce_dicts
        self.use_float = use_float
        self.handle_interrupt = handle_interrupt
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.mesh = mesh
        self.nnz_chunk = nnz_chunk
        self.layout = layout
        self.plane_dtype = plane_dtype
        self.max_cg = max_cg
        self.device = resolve_device(device, mesh)
        self._reset_state()

    def _reset_state(self):
        self._A = None  # device tensor [n_users_pad, k]
        self._B = None  # device tensor [n_items_pad, k]
        self._by_user = None  # host training data, absent after load()
        self._user_items_csr_cache = None
        self._fit_status = None
        self.user_mapping_ = np.empty(0, dtype=object)
        self.item_mapping_ = np.empty(0, dtype=object)
        self.user_dict_ = dict()
        self.item_dict_ = dict()
        self.nusers = 0
        self.nitems = 0
        self.Bsum = None
        self.Amean = None
        self.is_fitted = False

    @property
    def dtype(self):
        return np.float32 if self.use_float else np.float64

    def _params(self) -> FitParams:
        return FitParams(
            k=self.k, method=self.method, l2_reg=self.l2_reg,
            l1_reg=self.l1_reg, niter=self.niter, maxupd=self.maxupd,
            limit_step=self.limit_step, initial_step=self.initial_step,
            early_stop=self.early_stop, reuse_prev=self.reuse_prev,
            w_mult=self.weight_mult, nnz_chunk=self.nnz_chunk,
            layout=self.layout, plane_dtype=self.plane_dtype,
            max_cg=self.max_cg,
        ).resolved()

    # ------------------------------------------------------------ factors

    @property
    def A(self) -> np.ndarray:
        if self._A is None:
            return np.empty((0, 0), dtype=self.dtype)
        return self._A[: self.nusers].cpu().numpy()

    @property
    def B(self) -> np.ndarray:
        if self._B is None:
            return np.empty((0, 0), dtype=self.dtype)
        return self._B[: self.nitems].cpu().numpy()

    # ---------------------------------------------------------------- fit

    def fit(self, X):
        """Fit the model to a counts matrix: a pandas DataFrame(UserId,
        ItemId, Count), a SciPy COO, or a ``(rows, cols, vals, (n_users,
        n_items))`` tuple.  A non-DataFrame input forces ``reindex=False``."""
        p = self._fit_params()
        if type(X).__name__ != "DataFrame":
            self.reindex = False
        data = ingest(X, reindex=self.reindex, dtype=self.dtype)
        self._fit_ingested(data, p)
        self._produce_dicts()
        return self

    def _fit_params(self) -> FitParams:
        p = self._params()
        if self.mesh is not None:
            resolve_device(self.device, self.mesh)
        return p

    def _fit_ingested(self, data: IngestResult, p: FitParams):
        self.nusers = data.n_users
        self.nitems = data.n_items
        if data.user_mapping is not None:
            self.user_mapping_ = data.user_mapping
            self.item_mapping_ = data.item_mapping
        rng = _resolve_rng(self.random_state)
        A = train.initialize_factors(data.n_users, data.by_user.n_rows_pad,
                                     p.k, rng, self.dtype, self.device)
        B = train.initialize_factors(data.n_items, data.by_item.n_rows_pad,
                                     p.k, rng, self.dtype, self.device)
        self._run(A, B, data.by_user, data.by_item, p)

    def _run(self, A, B, by_user: CountsMatrix, by_item: CountsMatrix,
             p: FitParams):
        if self.mesh is not None:
            from ..parallel.mesh import run_poismf_sharded

            A, B, status = run_poismf_sharded(
                A, B, by_user, by_item, p, self.mesh,
                handle_interrupt=self.handle_interrupt,
            )
        else:
            A, B, status = train.run_poismf(
                A, B, by_user, by_item, p,
                handle_interrupt=self.handle_interrupt,
            )
        self._set_factors(A, B, p.l1_reg)
        self._by_user = by_user
        self._user_items_csr_cache = None
        self._fit_status = status

    def _set_factors(self, A, B, l1_reg: float):
        self._A, self._B = A, B
        # serving-side sufficient statistics
        self.Bsum = obj.make_bsum(B, self.nitems, l1_reg)
        self.Amean = self._A[: self.nusers].mean(0)
        self.is_fitted = True

    def fit_unsafe(self, A, B, Xcsr, Xcsc):
        """Fit from given initial factors A [m, k], B [n, k] and the data
        as SciPy CSR and CSC, without validation (also the warm start).
        The arrays are used as they are: ``reindex`` is turned off."""
        p = self._fit_params()
        self.reindex = False
        A = np.asarray(A, dtype=self.dtype)
        B = np.asarray(B, dtype=self.dtype)
        self.nusers, self.nitems = A.shape[0], B.shape[0]
        by_user = _counts_from_scipy(Xcsr, self.dtype)
        by_item = _counts_from_scipy(Xcsc.T.tocsr() if hasattr(Xcsc, "T")
                                     else Xcsc, self.dtype)
        A_pad = np.zeros((by_user.n_rows_pad, p.k), dtype=self.dtype)
        A_pad[: self.nusers] = A
        B_pad = np.zeros((by_item.n_rows_pad, p.k), dtype=self.dtype)
        B_pad[: self.nitems] = B
        self._run(profiling.to_device(A_pad, self.device, "fit.init"),
                  profiling.to_device(B_pad, self.device, "fit.init"),
                  by_user, by_item, p)
        return self

    def _produce_dicts(self):
        if not self.produce_dicts or not self.reindex:
            return
        self.user_dict_ = {u: i for i, u in enumerate(self.user_mapping_)}
        self.item_dict_ = {it: i for i, it in enumerate(self.item_mapping_)}

    # ------------------------------------------------------------ mapping

    @staticmethod
    def _map_through(ids: np.ndarray, dct: dict, mapping) -> np.ndarray:
        if dct:
            return np.fromiter((dct.get(u, -1) for u in ids), dtype=np.int64,
                               count=len(ids))
        import pandas as pd

        return pd.Index(mapping).get_indexer(ids)

    def _map_users(self, user) -> np.ndarray:
        users = _as_1d(user) if not np.isscalar(user) else np.array([user])
        if self.reindex and len(self.user_mapping_):
            return self._map_through(users, self.user_dict_,
                                     self.user_mapping_)
        return users.astype(np.int64)

    def _map_items(self, item) -> np.ndarray:
        items = _as_1d(item) if not np.isscalar(item) else np.array([item])
        if self.reindex and len(self.item_mapping_):
            return self._map_through(items, self.item_dict_,
                                     self.item_mapping_)
        return items.astype(np.int64)

    def _require_fitted(self):
        if not self.is_fitted:
            raise ValueError("Model is not fitted.")

    # ------------------------------------------------------------ predict

    def predict(self, user, item):
        """Expected counts for user/item pairs; invalid ids -> NaN.  Pairs
        go to the device ``PREDICT_CHUNK`` at a time."""
        self._require_fitted()
        scalar = np.isscalar(user) and np.isscalar(item)
        u = self._map_users(user)
        it = self._map_items(item)
        if u.shape[0] != it.shape[0]:
            raise ValueError("'user' and 'item' must have the same length.")
        bad = (u < 0) | (it < 0) | (u >= self.nusers) | (it >= self.nitems)
        out = np.full(u.shape[0], np.nan, dtype=self.dtype)
        ok = ~bad
        if np.any(ok):
            dev = self._A.device
            uu, ii = u[ok], it[ok]
            vals = np.empty(uu.shape[0], dtype=self.dtype)
            for s in range(0, uu.shape[0], PREDICT_CHUNK):
                vals[s:s + PREDICT_CHUNK] = profiling.host(
                    serve.predict_pairs(
                        self._A, self._B,
                        profiling.to_device(uu[s:s + PREDICT_CHUNK], dev,
                                            "serve.upload"),
                        profiling.to_device(ii[s:s + PREDICT_CHUNK], dev,
                                            "serve.upload")),
                    "serve.fetch").numpy()
            out[ok] = vals
        return float(out[0]) if scalar else out

    # --------------------------------------------------------------- topN

    def _process_include_exclude(self, include, exclude):
        if include is not None and exclude is not None:
            raise ValueError("Can only pass one of 'include' or 'exclude'.")

        def _remap(lst):
            arr = self._map_items(_as_1d(lst))
            if np.any(arr < 0) or np.any(arr >= self.nitems):
                raise ValueError("'include'/'exclude' contains invalid items.")
            return arr

        return (_remap(include) if include is not None else None,
                _remap(exclude) if exclude is not None else None)

    def topN(self, user, n=10, include=None, exclude=None,
             output_score=False):
        """Top-N highest-predicted items for an existing user."""
        self._require_fitted()
        u = self._map_users(user)
        if u.shape[0] != 1 or u[0] < 0 or u[0] >= self.nusers:
            raise ValueError("Invalid user.")
        include_ix, exclude_ix = self._process_include_exclude(include,
                                                               exclude)
        res = serve.top_n(
            self._A[int(u[0])], self._B, n_top=n, include_ix=include_ix,
            exclude_ix=exclude_ix, n_items=self.nitems,
            output_score=output_score,
        )
        return self._map_topn_out(res, output_score)

    def _map_topn_out(self, res, output_score):
        idx, score = res if output_score else (res, None)
        if self.reindex and len(self.item_mapping_):
            idx = np.asarray(self.item_mapping_)[idx]
        return (idx, score) if output_score else idx

    def topN_batched(self, users, n=10, exclude_seen=False,
                     output_score=False):
        """Top-N for a batch of existing users in one matmul
        (``serve.top_n_batched``).  ``exclude_seen=True`` leaves out each
        user's own training items (it needs the training data: a model
        fitted in this process).  Returns ``[len(users), n]`` item ids
        (remapped when ``reindex``), plus scores when ``output_score``."""
        self._require_fitted()
        with profiling.span("topn"):
            u = self._map_users(users)
            if np.any(u < 0) or np.any(u >= self.nusers):
                raise ValueError("'users' contains invalid users.")
            if n > self.nitems:
                raise ValueError("'n' is larger than the number of items.")
            if exclude_seen:
                vals, idx = self._topn_batched_excl_seen(u, n)
            else:
                with profiling.span("topn.rank"):
                    vals, idx = serve.top_n_batched(
                        self._A[profiling.to_device(u, self._A.device,
                                                    "topn.upload")],
                        self._B, n, n_items=self.nitems,
                    )
                with profiling.span("topn.fetch"):
                    vals = profiling.host(vals, "topn.fetch").numpy()
                    idx = profiling.host(idx, "topn.fetch").numpy()
            if self.reindex and len(self.item_mapping_):
                mapped = np.asarray(self.item_mapping_)[np.maximum(idx, 0)]
                if np.any(idx < 0):
                    mapped = mapped.astype(object)
                    mapped[idx < 0] = -1
                idx = mapped
            if output_score:
                return idx, vals
            return idx

    # users per exclusion call: bounds the [Qc, n_items_pad] score buffer
    # (2,048 x 160,112 float32, 1.3 GB at the Last.FM catalog)
    _EXCL_CHUNK = 2048

    def _topn_batched_excl_seen(self, u: np.ndarray, n: int):
        """``exclude_seen`` ranking: per chunk of users, the padded [Qc, L]
        training-item lists (L the chunk's longest list) built on the host
        and set to -inf on the device (``serve.top_n_batched_excl``)."""
        if u.shape[0] == 0:
            return (np.zeros((0, n), dtype=self.dtype),
                    np.zeros((0, n), dtype=np.int64))
        indptr, indices = self._user_items_csr()
        dev = self._A.device
        idx_parts, val_parts = [], []
        for s in range(0, u.shape[0], self._EXCL_CHUNK):
            with profiling.span("topn.lists"):
                uu = u[s:s + self._EXCL_CHUNK]
                starts = indptr[uu]
                lens = indptr[uu + 1] - starts
                pos = np.arange(max(int(lens.max()), 1),
                                dtype=np.int64)[None, :]
                valid = pos < lens[:, None]
                gidx = np.minimum(starts[:, None] + pos,
                                  max(indices.shape[0] - 1, 0))
                items = np.where(valid, indices[gidx], 0).astype(np.int64)
            with profiling.span("topn.rank"):
                vals_c, idx_c = serve.top_n_batched_excl(
                    self._A[profiling.to_device(uu, dev, "topn.upload")],
                    self._B, profiling.to_device(items, dev, "topn.upload"),
                    profiling.to_device(valid, dev, "topn.upload"), n,
                    n_items=self.nitems,
                )
            with profiling.span("topn.fetch"):
                idx_parts.append(profiling.host(idx_c, "topn.fetch").numpy())
                val_parts.append(profiling.host(vals_c,
                                                "topn.fetch").numpy())
        return np.concatenate(val_parts), np.concatenate(idx_parts)

    def _user_items_csr(self):
        """Host CSR (indptr, indices) of the training by-user matrix,
        cached after the first call; refitting resets it."""
        if self._by_user is None:
            raise ValueError(
                "No training data attached to this model (e.g. it was "
                "restored from a checkpoint); 'exclude_seen' is unavailable."
            )
        if self._user_items_csr_cache is None:
            indptr, indices, _ = csr_like(self._by_user)
            self._user_items_csr_cache = (indptr, indices)
        return self._user_items_csr_cache

    def topN_new(self, X, n=10, include=None, exclude=None,
                 output_score=False, l2_reg=None, l1_reg=None,
                 weight_mult=None, maxupd=None):
        """Top-N for a NEW user given their item counts: cold-start
        factors (``predict_factors``, always tncg), then the ranking."""
        a_vec = self.predict_factors(
            X, l2_reg=l2_reg, l1_reg=l1_reg, weight_mult=weight_mult,
            maxupd=maxupd,
        )
        include_ix, exclude_ix = self._process_include_exclude(include,
                                                               exclude)
        res = serve.top_n(
            profiling.to_device(a_vec, self._B.device, "serve.upload"),
            self._B, n_top=n,
            include_ix=include_ix, exclude_ix=exclude_ix,
            n_items=self.nitems, output_score=output_score,
        )
        return self._map_topn_out(res, output_score)

    # ------------------------------------------- out-of-sample factor solves

    def _process_data_single(self, X):
        """(item ids, counts) of one user, from a DataFrame(ItemId, Count)
        or an (items, counts) tuple."""
        import pandas as pd

        if isinstance(X, pd.DataFrame):
            if X.shape[0] == 0:
                raise ValueError("'X' is empty.")
            if "ItemId" not in X.columns or "Count" not in X.columns:
                raise ValueError("'X' must have columns ItemId, Count")
            items = X["ItemId"].to_numpy()
            counts = X["Count"].to_numpy()
        elif isinstance(X, (tuple, list)):
            items = np.asarray(X[0]).reshape(-1)
            counts = np.asarray(X[1]).reshape(-1)
            if items.shape[0] != counts.shape[0]:
                raise ValueError(
                    "'X' must have the same number of entries for items "
                    "and counts."
                )
        else:
            raise ValueError("'X' must be a DataFrame or tuple.")
        items = self._map_items(items)
        if items.min(initial=0) < 0 or items.max(initial=0) >= self.nitems:
            raise ValueError("'X' contains invalid items.")
        return items.astype(np.int32), counts.astype(self.dtype)

    def predict_factors(self, X, l2_reg=None, l1_reg=None, weight_mult=None,
                        maxupd=None):
        """Latent factors ``[k]`` of one NEW user, always by the flat-COO
        tncg whatever the training method or layout; ``maxupd`` defaults
        to max(1000, the fit's)."""
        self._require_fitted()
        p = self._params()
        l2 = p.l2_reg if l2_reg is None else float(l2_reg)
        l1_new = p.l1_reg if l1_reg is None else float(l1_reg)
        w = p.w_mult if weight_mult is None else float(weight_mult)
        mu = max(1000, p.maxupd) if maxupd is None else int(maxupd)
        items, counts = self._process_data_single(X)
        out = serve.factors_single(
            self._B, self.Bsum, self.Amean, items, counts,
            l2_reg=l2, l1_new=l1_new, l1_old=p.l1_reg, w_mult=w,
            # from Amean only when reuse_prev, else from 1e-3
            maxupd=mu, reuse_mean=self.reuse_prev, n_items=self.nitems,
        )
        out = profiling.host(out, "serve.fetch").numpy()
        if np.any(np.isnan(out)):
            raise ValueError(
                "NaNs encountered in the result. Failed to produce factors."
            )
        if np.max(out) <= 0:
            raise ValueError(
                "Optimization failed. Could not calculate factors."
            )
        return out

    def transform(self, X, y=None):
        """Latent factors of a BATCH of new users, by the fit's method and
        hyperparameters (on the fit's layout when it is "ell" and the
        batch has more than ``serve.ELL_SERVE_NNZ_THRESHOLD`` nonzeros,
        else on the flat COO).  DataFrame(UserId, ItemId, Count) input returns
        ``(A_new, user_mapping)``; SciPy CSR / COO input returns ``A_new``
        row-matched to X."""
        self._require_fitted()
        p = self._params()
        import pandas as pd

        user_mapping = np.empty(0, dtype=object)
        if isinstance(X, pd.DataFrame):
            required = ["UserId", "ItemId", "Count"]
            if any(c not in X.columns for c in required):
                raise ValueError(
                    "'X' must contain columns " + ", ".join(required)
                )
            codes, user_mapping = pd.factorize(X["UserId"])
            items = self._map_items(X["ItemId"].to_numpy())
            if np.any(items < 0):
                raise ValueError("'X' contains invalid items.")
            n_new = int(codes.max()) + 1
            X_new = build_counts(
                np.asarray(codes, dtype=np.int32), items.astype(np.int32),
                X["Count"].to_numpy(), n_new, self.nitems, dtype=self.dtype,
            )
        else:
            if self.reindex and len(self.item_mapping_):
                raise ValueError(
                    "'X' must be a DataFrame if using 'reindex=True'."
                )
            csr = X.tocsr() if hasattr(X, "tocsr") else X
            if csr.shape[1] > self.nitems:
                raise ValueError(
                    "'X' must have the same columns (items) as passed to "
                    "'fit'."
                )
            X_new = _counts_from_scipy(csr, self.dtype)
            n_new = csr.shape[0]
        A_new = serve.factors_multiple(
            self._B, self.Bsum, self.Amean, X_new, p,
            reuse_mean=self.reuse_prev or self.method != "tncg",
        )
        A_new = profiling.host(A_new[:n_new], "serve.fetch").numpy()
        if user_mapping.shape[0]:
            return A_new, np.asarray(user_mapping)
        return A_new

    # --------------------------------------------------------- evaluation

    def eval_llk(self, X=None, full_llk=False, include_missing=False):
        """Poisson log-likelihood of the fitted model on its training data
        (or on ``X = (users, items, counts)`` triplets)."""
        self._require_fitted()
        if X is None:
            if self._by_user is None:
                raise ValueError(
                    "No training data attached to this model (e.g. it was "
                    "restored from a checkpoint). Pass X=(users, items, "
                    "counts) triplets to evaluate."
                )
            return float(obj.eval_llk(self._A, self._B, self._by_user,
                                      full_llk=full_llk,
                                      include_missing=include_missing))
        dev = self._A.device
        u = torch.as_tensor(self._map_users(X[0]), device=dev)
        it = torch.as_tensor(self._map_items(X[1]), device=dev)
        vals = torch.as_tensor(np.asarray(X[2], dtype=self.dtype), device=dev)
        return float(obj.eval_llk_entries(self._A, self._B, u, it, vals,
                                          full_llk=full_llk))

    # -------------------------------------------------------- persistence

    def save(self, path: str):
        from ..io.checkpoint import save_model

        save_model(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "PoisMF":
        from ..io.checkpoint import load_model

        return load_model(path, device=device)

    def __repr__(self):
        status = "fitted" if self.is_fitted else "not fitted"
        return (f"PoisMF(k={self.k}, method='{self.method}', {status}, "
                f"users={self.nusers}, items={self.nitems}, "
                f"device='{self.device}')")

    __str__ = __repr__


def _counts_from_scipy(csr, dtype) -> CountsMatrix:
    coo = csr.tocoo()
    return build_counts(
        coo.row.astype(np.int32), coo.col.astype(np.int32), coo.data,
        coo.shape[0], coo.shape[1], dtype=dtype,
    )


def _resolve_rng(random_state):
    if isinstance(random_state, np.random.Generator):
        return random_state
    if random_state is None:
        return np.random.default_rng()
    if isinstance(random_state, np.random.RandomState):
        return np.random.default_rng(random_state.randint(2**31 - 1))
    return np.random.default_rng(int(random_state))
