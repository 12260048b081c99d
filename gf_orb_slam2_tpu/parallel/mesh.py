"""Device mesh helpers for multi-device distributed BA.

The reference has NO distribution (single process, SURVEY.md §2.3 P9/—);
this layer is the new scaling design: keyframes/map-point blocks sharded
over a 1-D `jax.sharding.Mesh`, Schur-complement reductions as `psum` over
the mesh, pose solve replicated. The cards of one host are joined all to
all, so one mesh axis is all the algorithm needs.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DP_AXIS = "dp"      # map points / observations sharded over this axis


def make_mesh(n_devices: int | None = None, axis: str = DP_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))
