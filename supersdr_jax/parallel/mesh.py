"""Mesh construction for SDR workloads.

The parallel axes of a software-radio pipeline (SURVEY.md §2a):

  chan  — virtual receivers (embarrassingly parallel; the "DP" axis)
  time  — stream blocks along the time axis with halo exchange for filter
          history (the "CP/ring-attention" axis)

A 2-D ('chan', 'time') mesh covers every deployment this framework targets;
hosts map onto whichever axis is outermost so halo ppermutes stay on the
intra-host links (NVLink).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAN_AXIS = "chan"
TIME_AXIS = "time"


def make_mesh(n_chan: int | None = None, n_time: int | None = None,
              devices=None) -> Mesh:
    """Build a ('chan', 'time') mesh. Defaults: all devices on the channel
    axis (n_time=1). Pass n_time to trade devices to time-sharding."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_chan is None and n_time is None:
        n_chan, n_time = n, 1
    elif n_chan is None:
        n_chan = n // n_time
    elif n_time is None:
        n_time = n // n_chan
    if n_chan * n_time != n:
        raise ValueError(f"{n_chan}x{n_time} != {n} devices")
    dev_array = np.asarray(devices).reshape(n_chan, n_time)
    return Mesh(dev_array, (CHAN_AXIS, TIME_AXIS))


def time_mesh(devices=None) -> Mesh:
    """All devices on the time axis (pure sequence-parallel)."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices).reshape(1, len(devices)),
                (CHAN_AXIS, TIME_AXIS))


def chan_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """[chan, time_samples]: shard channels, replicate time."""
    spec = [None] * ndim
    spec[0] = CHAN_AXIS
    return NamedSharding(mesh, P(*spec))


def time_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """[... , time_samples]: shard the trailing time axis."""
    spec = [None] * ndim
    spec[-1] = TIME_AXIS
    return NamedSharding(mesh, P(*spec))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """[chan, time_samples] sharded over both mesh axes."""
    return NamedSharding(mesh, P(CHAN_AXIS, TIME_AXIS))
