"""Tiled and sharded generation on ``torch.distributed``; port of
``noize_tpu.parallel``.

One rank drives one device (a card with NCCL, or the CPU with gloo).  The
JAX constructs map to PyTorch ones as follows, in every module here:

| JAX | port |
| --- | --- |
| a ``Mesh`` with axes ``x``, ``y`` / ``batch`` | a ``DeviceMesh`` from ``init_device_mesh`` with the same ``mesh_dim_names`` |
| a global array sharded ``P('x', 'y')`` | a ``DTensor`` placed ``Shard(0)``, ``Shard(1)`` (``device_mesh.field_sharding``) |
| a ``shard_map`` body | code on the local block (``DTensor.to_local()``) |
| ``lax.ppermute`` | ``dist.batch_isend_irecv`` on the axis' group (``mesh.get_group(axis)``) |
| ``psum`` | ``dist.all_reduce`` |
| ``lax.axis_index`` | ``mesh.get_local_rank(axis)`` |

The sharded ops take and return ``DTensor``s (a plain tensor is taken as
the whole grid, the same on every rank); ``tile_batch(mesh=...)`` returns
its stack as a ``DTensor`` sharded on the tile axis (``.full_tensor()``
gathers it).  Blocks divide evenly, as the reference requires.
"""
