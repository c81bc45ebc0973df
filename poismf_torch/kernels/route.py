"""The port's one route rule: which version of a kernel a call runs.

The layers above ask for an operation by its wrapper's name in
:mod:`poismf_torch.kernels` and never choose a version.  The route
follows the JAX package's choice of Pallas or jnp under x64, from dtypes
alone (never from a failed launch):

- the plain version (the wrapper's ``_torch`` twin, on the tensors' own
  device and dtype) where the tensor that sets the route is float64: the
  plane ``bg`` of a plane sweep (fgh, hvp, hvp_bv, fg, f, pg, f_gtd,
  f_gtd_fused; JAX ``ops/ell.py`` :634, :666, :683, :750, :1079, :1211,
  :1265, :1332), ``px`` of a ray search (raygtd, ray, rayf; :897, :924,
  :979), the state of a line-search round (``ls_round`` applies the rule
  itself);
- otherwise the wrapper on float32 casts of the other inputs, whose
  device half (``_lib.plain_device``) runs the plain version on the CPU
  and on CUDA one launch or a raise.

``f_gtd_multi`` takes its kernel unless the planes or the iterate are
float64 (:830-835): ``ops.ell.f_gtd_multi_ell`` asks :func:`takes_plain`
of both and, where either is float64, runs JAX's fallback: f_gtd_fused
at each trial, each by its own route.
``assemble`` has no dtype half: on CUDA it launches for float32 and
float64 alike.  A wrapper handed a float64 tensor on CUDA still raises.
Both versions are looked up on the package at call time, so a wrapper
replaced there sees every call that takes its route, and a call on the
plain route never passes through the wrapper.
"""

from __future__ import annotations

import sys

import torch


def takes_plain(t: torch.Tensor) -> bool:
    """Whether ``t``, the tensor that sets a call's route, sends the call
    to the plain version: float64."""
    return t.dtype == torch.float64


def _version(name: str, plain: bool):
    return getattr(sys.modules[__package__],
                   name + "_torch" if plain else name)


def sweep(name: str, bg: torch.Tensor, *xs: torch.Tensor, **kw):
    """The plane sweep ``name`` (a wrapper's name) on the plane ``bg``,
    which sets the route, and ``xs``: the wrapper on float32 casts of
    ``xs``, or the plain version on ``xs`` in their own dtype."""
    if takes_plain(bg):
        return _version(name, True)(bg, *(x.contiguous() for x in xs), **kw)
    return _version(name, False)(
        bg, *(x.to(torch.float32).contiguous() for x in xs), **kw)


def ray(name: str, px: torch.Tensor, pd: torch.Tensor, vals: torch.Tensor,
        alphas: torch.Tensor):
    """The ray search ``name`` on the planes ``px`` (which sets the
    route), ``pd`` and ``vals`` at the steps ``alphas``, as :func:`sweep`
    with ``px`` among the cast inputs."""
    xs = (px, pd, vals, alphas)
    if takes_plain(px):
        return _version(name, True)(*(x.contiguous() for x in xs))
    return _version(name, False)(
        *(x.to(torch.float32).contiguous() for x in xs))
