"""Multi-host ingest: distributing a wideband stream over DCN.

SURVEY.md §5's last hard part: feeding a pod slice without a single-host
bottleneck. Design (jax.distributed / multi-process):

  * every host runs its own source (digitizer slice, file shard, or
    network tap) producing the *time* range its devices own, plus the
    halo overlap consumed from the previous host's range
  * `make_global_iq` assembles the per-process blocks into one global
    jax.Array sharded over the ('chan','time') mesh with
    `jax.make_array_from_process_local_data` — no host ever materializes
    the full capture
  * the sharded pipelines (parallel/sharded_chain, sharded_wideband) then
    run unchanged: halo ppermutes ride NVLink within a host and the
    network between hosts, which is exactly the locality the ('chan','time') axis order
    encodes (mesh.py).

Single-process environments degrade to a plain device_put with the same
sharding, so the code path is testable anywhere.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Bring up jax.distributed when running multi-host (no-op when the
    arguments are absent and JAX already sees its devices)."""
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def local_time_range(total_samples: int, mesh: Mesh,
                     time_axis: str = "time") -> tuple[int, int]:
    """[start, end) of the time axis this process's devices own."""
    n_time = mesh.shape[time_axis]
    shard = total_samples // n_time
    # which time shards live on this process?
    my_ids = {d.id for d in jax.local_devices()}
    axes = list(mesh.axis_names)
    t_pos = axes.index(time_axis)
    dev_grid = mesh.devices
    owned = []
    for idx in np.ndindex(dev_grid.shape):
        if dev_grid[idx].id in my_ids:
            owned.append(idx[t_pos])
    lo, hi = min(owned), max(owned)
    return lo * shard, (hi + 1) * shard


def make_global_iq(local_block: np.ndarray, global_shape: tuple[int, ...],
                   mesh: Mesh, spec: P) -> jax.Array:
    """Assemble per-process local data into a global sharded array.

    local_block must be exactly this process's shard(s) of the global
    array under `spec` (use `local_time_range` to compute what to read).
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local_block, sharding)
    return jax.make_array_from_process_local_data(sharding, local_block,
                                                  global_shape)
