"""Faults planted under a run's timed path, for the tests and readings that
see the check come out false.  ``apply(name)`` patches the port in this
process; ``undo()`` restores it.

* ``stale``: every eval returns the answers of the first one (a step that
  returns its state unchanged);
* ``half``: half of each batch is left out (its answers are 0);
* ``altered``: one answer of each batch is altered where it is produced;
* ``neighbour``: every locate route (the locate kernel, the brute force,
  the cell index with its walk) returns, for each query, the triangle
  across its located triangle's first edge, with that triangle's weights:
  a wrong locate by one step, which only the density of the sites keeps
  close to the right value.
"""

from __future__ import annotations

import torch

_SAVED: list = []


def _patch(module, name, new) -> None:
    _SAVED.append((module, name, getattr(module, name)))
    setattr(module, name, new)


def undo() -> None:
    while _SAVED:
        module, name, old = _SAVED.pop()
        setattr(module, name, old)


def _neighbour(tri, q_raw, leaf):
    from gsl_scattered_interpolation_torch.models import device_tri

    nbr = tri.tri_nbrs[leaf.long(), 0].long()
    leaf = torch.where(nbr >= 0, nbr, leaf.long())
    return leaf, device_tri._weights(tri, leaf, q_raw)


def apply(name: str) -> None:
    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.ops import locate as locate_ops

    interp = device_tri.interp
    first = {}

    def stale(tri, response_ext, q_raw, **kw):
        if q_raw.shape not in first:
            first[q_raw.shape] = interp(tri, response_ext, q_raw, **kw)
        return first[q_raw.shape].clone()

    def half(tri, response_ext, q_raw, **kw):
        out = torch.zeros(q_raw.shape[0], dtype=q_raw.dtype, device=q_raw.device)
        h = q_raw.shape[0] // 2
        out[:h] = interp(tri, response_ext, q_raw[:h], **kw)
        return out

    def altered(tri, response_ext, q_raw, **kw):
        out = interp(tri, response_ext, q_raw, **kw)
        i = torch.randint(0, out.shape[0], (1,), device=out.device)
        out[i] += 0.5
        return out

    if name in ("stale", "half", "altered"):
        _patch(device_tri, "interp", {"stale": stale, "half": half, "altered": altered}[name])
    elif name == "neighbour":
        kernel, dense, cells = (locate_ops.locate_weights_kernel, device_tri.locate_dense,
                                device_tri.locate_cells)

        def on_kernel(tri, q_raw):
            return _neighbour(tri, q_raw, kernel(tri, q_raw)[0])

        def on_dense(tri, q_raw, *a, **kw):
            leaf, _, ok = dense(tri, q_raw, *a, **kw)
            return (*_neighbour(tri, q_raw, leaf), ok)

        def on_cells(tri, index, q_raw, *a, **kw):
            leaf, _, ok = cells(tri, index, q_raw, *a, **kw)
            return (*_neighbour(tri, q_raw, leaf), ok)

        _patch(locate_ops, "locate_weights_kernel", on_kernel)
        _patch(device_tri, "locate_dense", on_dense)
        _patch(device_tri, "locate_cells", on_cells)
    else:
        raise ValueError(f"unknown fault {name!r}")
