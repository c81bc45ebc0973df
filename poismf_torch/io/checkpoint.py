"""Model persistence, in the JAX package's npz format (v3).

``load_model`` reads a checkpoint written by ``poismf_tpu`` (or by
:func:`save_model`) into a port :class:`~poismf_torch.PoisMF`;
``model_from_numpy`` builds a fitted port model from factor matrices held
as NumPy arrays.  Either way both packages serve from the same factors.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..sparse import ROW_PAD_MULTIPLE, _pad_to

_HYPERPARAMS = [
    "k", "method", "l2_reg", "l1_reg", "niter", "maxupd", "limit_step",
    "initial_step", "early_stop", "reuse_prev", "weight_mult", "random_state",
    "reindex", "copy_data", "produce_dicts", "use_float", "handle_interrupt",
    "nnz_chunk", "layout", "plane_dtype", "max_cg",
]

_FORMAT_VERSION = 3


def save_model(model, path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    hp = {"__format_version__": _FORMAT_VERSION}
    for name in _HYPERPARAMS:
        v = getattr(model, name)
        if isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        if isinstance(v, (int, float, str, bool)) or v is None:
            hp[name] = v
    arrays = dict(
        A=model.A, B=model.B,
        nusers=np.asarray(model.nusers), nitems=np.asarray(model.nitems),
        hyperparams=np.frombuffer(json.dumps(hp).encode("utf-8"),
                                  dtype=np.uint8),
        is_fitted=np.asarray(model.is_fitted),
    )
    if model.Bsum is not None:
        arrays["Bsum"] = model.Bsum.cpu().numpy()
        arrays["Amean"] = model.Amean.cpu().numpy()
    if len(model.user_mapping_):
        arrays["user_mapping"] = np.asarray(model.user_mapping_)
        arrays["item_mapping"] = np.asarray(model.item_mapping_)
    np.savez_compressed(path, **arrays)


def _padded(M: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((_pad_to(n, ROW_PAD_MULTIPLE), M.shape[1]), dtype=M.dtype)
    out[:n] = M
    return out


def model_from_numpy(A: np.ndarray, B: np.ndarray, device="cuda",
                     **hyperparams):
    """A fitted port model serving the factors ``A`` [n_users, k] and
    ``B`` [n_items, k] (ids are row positions: ``reindex=False``)."""
    from ..models.poismf import PoisMF

    A = np.asarray(A)
    B = np.asarray(B)
    hyperparams.setdefault("k", A.shape[1])
    hyperparams.setdefault("use_float", A.dtype != np.float64)
    hyperparams.setdefault("reindex", False)
    model = PoisMF(device=device, **hyperparams)
    model.nusers, model.nitems = A.shape[0], B.shape[0]
    dev = model.device
    model._set_factors(torch.from_numpy(_padded(A, A.shape[0])).to(dev),
                       torch.from_numpy(_padded(B, B.shape[0])).to(dev),
                       model._params().l1_reg)
    return model


def load_model(path: str, device="cuda"):
    from ..models.poismf import PoisMF

    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=True) as data:
        hp = json.loads(bytes(data["hyperparams"]).decode("utf-8"))
        version = hp.pop("__format_version__", 1)
        if version > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format v{version} is newer than this build "
                f"(v{_FORMAT_VERSION})"
            )
        model = PoisMF(device=device, **hp)
        model.nusers = int(data["nusers"])
        model.nitems = int(data["nitems"])
        model.is_fitted = bool(data["is_fitted"])
        dev = model.device
        if model.is_fitted:
            model._A = torch.from_numpy(
                _padded(data["A"], model.nusers)).to(dev)
            model._B = torch.from_numpy(
                _padded(data["B"], model.nitems)).to(dev)
            if "Bsum" in data:
                model.Bsum = torch.from_numpy(data["Bsum"]).to(dev)
                model.Amean = torch.from_numpy(data["Amean"]).to(dev)
        if "user_mapping" in data:
            model.user_mapping_ = data["user_mapping"]
            model.item_mapping_ = data["item_mapping"]
            model._produce_dicts()
    return model
