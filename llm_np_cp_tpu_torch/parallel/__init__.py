"""Parallelism over ``torch.distributed`` (port of ``llm_np_cp_tpu/parallel``).

The JAX package has one controller: a ``Mesh`` over ``jax.devices()``,
NamedShardings, and GSPMD inserting ``psum`` / ``all_gather`` /
``ppermute``.  The port is SPMD in PyTorch's idiom: one process per
rank, a ``DeviceMesh`` whose groups name the mesh axes, each rank holding
its own shards, and explicit collectives where GSPMD inserted them:

- ``sharding.py``: ``MeshPlan``, the spec trees (``P``), ``make_mesh``
  and ``shard_params`` (this rank's local shards);
- ``collectives.py``: ``all_reduce`` / ``all_gather`` / ``ppermute`` over
  one named axis's group, host-staged where a gloo group holds CUDA
  tensors;
- ``ring_attention.py``: sequence-parallel causal attention over the
  ``seq`` axis;
- ``launch.py``: spawning a group of ranks on one host and returning
  what each rank's function returned;
- ``pipeline.py``: GPipe over the ``pipe`` axis (training and the
  cache-less forward).

The collectives carry gradients (``copy_to`` marks where a replicated
value enters per-rank work), so ``train.py`` differentiates the mesh
forward with ``torch.autograd``.

The tensor-, data- and sequence-parallel forward is
``models.transformer.forward(..., mesh=)``; the ``Generator`` takes the
same ``mesh=``.
"""
