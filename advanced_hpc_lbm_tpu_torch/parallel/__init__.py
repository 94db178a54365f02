"""Multi-device execution: device meshes (``mesh``) and the halo-exchanged
domain decomposition of the step over them (``halo``).

The counterpart of ``advanced_hpc_lbm_tpu.parallel``'s ``mesh`` and
``halo``.  One process drives every shard: per-shard tensors live on the
mesh's devices and halos travel as tensor copies between them.
"""
