"""Host-side numpy helpers of the fast cycle.

``water_fill_np`` is the port's copy of ``volcano_tpu/native/__init__.py``
``water_fill_np``: proportion water-filling in numpy.  The contention
passes take their ``deserved`` shares from it, on the host, as the
reference cycle does (the allocate solve takes them from the water-fill
kernel).
"""

from __future__ import annotations

import numpy as np


def water_fill_np(weight, request, total, eps, participates) -> np.ndarray:
    """Numpy proportion water-filling: deserved [Q, R]."""
    weight = np.asarray(weight, np.float32)
    request = np.asarray(request, np.float32)
    remaining = np.asarray(total, np.float32).copy()
    eps = np.asarray(eps, np.float32)
    participates = np.asarray(participates, bool)
    deserved = np.zeros_like(request)
    met = np.zeros(weight.shape[0], bool)
    while True:
        live = participates & ~met
        total_weight = weight[live].sum()
        if total_weight <= 0:
            break
        frac = np.where(live, weight / total_weight, 0.0)
        new_deserved = deserved + remaining[None, :] * frac[:, None]
        exceeded = ~np.all(new_deserved < request + eps, axis=-1) & live
        capped = np.where(
            exceeded[:, None], np.minimum(new_deserved, request), new_deserved
        )
        capped = np.where(live[:, None], capped, deserved)
        met |= exceeded
        remaining = remaining - (capped - deserved).sum(axis=0)
        deserved = capped
        if np.all(remaining < eps):
            break
    return deserved.astype(np.float32)
