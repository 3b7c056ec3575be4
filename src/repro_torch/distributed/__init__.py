"""Multi-rank execution of the port (twin of ``repro/distributed``).

JAX runs one controller over a ``jax.sharding.Mesh``: ``shard_map`` hands
each device its slice and ``psum`` / ``pmax`` merge the slices. The port
is SPMD over ``torch.distributed`` ranks instead: one process per shard,
each holding the replicated model and its own slice of what is sharded,
and the merges are ``all_reduce`` calls over the mesh axis's process
group (gloo, on the CPU and on the card: NCCL refuses two ranks on one
device, and a CUDA payload is staged through host memory).

* ``sharding`` — the :class:`~repro_torch.distributed.sharding.Mesh`
  (axis names, shape, this rank's coordinates, a process group per axis),
  the logical-axis rules and the thread-local ``use_sharding`` context;
* ``spdecode`` — KV-sequence-sharded decode attention: the dense and the
  paged cache reads under a ``kv_seq`` axis and their log-sum-exp merge;
* ``ep`` — expert parallelism over the ``experts`` axis: each rank runs
  its part of every expert stack on every token, one SUM all-reduce a
  MoE layer (differentiable);
* ``collectives`` — the int8 gradient all-reduce with error feedback
  over the ``data`` axis.

``repro/distributed/compat.py`` has no twin: it only spells JAX APIs
across JAX versions (``shard_map``'s ``check_vma`` / ``check_rep``,
``make_mesh``'s ``axis_types``, ``pvary``), none of which the SPMD form
needs. A mesh has a process group for each of its ``data`` and
``model`` axes (``launch/mesh.py::make_mesh``); the serving engine and
``pipeline.generate`` refuse a ``data`` axis larger than 1 with
``NotImplementedError`` (ROADMAP.md queue 1, item 9a).
"""
