"""Device meshes and sharding helpers.

The reference's parallelism is threads + child processes on one Windows host
(SURVEY.md §2.3); the analogue here is a jax.sharding.Mesh whose axes
carry:

- ``ch``  — channel-parallelism (rows of the batched channelizer / decode
            window batch), the throughput axis;
- ``t``   — time-sharding for long capture windows (FST4-900/1800), with
            FIR-halo exchange between neighbors (see timeshard.py).
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: int | None = None,
    axes: Sequence[str] = ("ch",),
    shape: Sequence[int] | None = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    With one axis, all devices go to it.  With two axes, ``shape`` picks the
    factorization (default: all on the first axis).
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    arr = np.array(devices).reshape(tuple(shape))
    return Mesh(arr, tuple(axes))


def channel_sharding(mesh: Mesh, axis: str = "ch") -> NamedSharding:
    """[C, ...] arrays sharded on the channel axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
