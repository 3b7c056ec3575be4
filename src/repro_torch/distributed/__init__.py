"""Multi-rank execution of the port (twin of ``repro/distributed``).

JAX runs one controller over a ``jax.sharding.Mesh``: ``shard_map`` hands
each device its slice and ``psum`` / ``pmax`` merge the slices. The port
is SPMD over ``torch.distributed`` ranks instead: one process per shard,
each holding the replicated model and its own slice of what is sharded,
and the merges are ``all_reduce`` calls over the mesh axis's process
group (gloo, on the CPU and on the card: NCCL refuses two ranks on one
device, and a CUDA payload is staged through host memory).

* ``sharding`` — the :class:`~repro_torch.distributed.sharding.Mesh`
  (axis names, shape, this rank's coordinates, its process groups), the
  logical-axis rules with JAX's ``logical_to_pspec`` / ``fit_spec``, the
  thread-local ``use_sharding`` context (with JAX's ``fsdp`` flag), the
  batch axes' runs of rows (``batch_run``: a wave's rows split over
  ``pod`` and ``data``, each rank computing its run) and the parameter
  rules (``param_pspec``, ``params_shardings``, ``shard_tree``,
  ``gather_tree``, ``constrain_params``);
* ``spdecode`` — KV-sequence-sharded decode attention: the dense and the
  paged cache reads under a ``kv_seq`` axis and their log-sum-exp merge;
* ``ep`` — expert parallelism over the ``experts`` axis: each rank runs
  its part of every expert stack on every token, one SUM all-reduce a
  MoE layer (differentiable);
* ``collectives`` — the int8 gradient all-reduce with error feedback
  over the ``data`` axis;
* ``train_mesh`` — training on the mesh: the parameter rules'
  storage (``sharding.params_shardings``), tensor, sequence and FSDP
  parallelism over ``model`` and ``data`` and data parallelism over the
  batch axes, their collectives as autograd Functions, and the table of
  the gradients' sums (``launch/steps.py::make_train_step``);
* ``device_exchange`` — the train step's collectives among ranks that
  share one card, through CUDA IPC (gloo carries only barriers);
* ``pipeline_parallel`` — GPipe over the ``pod`` axis
  (``pipeline_apply``, forward only).

``repro/distributed/compat.py`` has no twin: it only spells JAX APIs
across JAX versions (``shard_map``'s ``check_vma`` / ``check_rep``,
``make_mesh``'s ``axis_types``, ``pvary``), none of which the SPMD form
needs. A mesh has a process group for each line of each of its axes
(``pod``, ``data``, ``model``) and a batch group over ``("pod",
"data")`` (``launch/mesh.py::make_mesh``).
"""
