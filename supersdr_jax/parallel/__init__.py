"""Mesh sharding layer: channel-parallel and time-parallel (sequence-
parallel) execution of receiver chains over a `jax.sharding.Mesh`, with
overlap-save halos and streaming recurrences exchanged via XLA collectives
(ppermute / all_gather; NCCL over NVLink on GPUs)."""
