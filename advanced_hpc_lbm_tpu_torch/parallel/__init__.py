"""Multi-device execution: device meshes (``mesh``), the halo-exchanged
domain decomposition of the step over them (``halo``) and batches of
independent decks (``batch``).

The counterpart of ``advanced_hpc_lbm_tpu.parallel``'s ``mesh``, ``halo``
and ``batch``.  One process drives every shard: per-shard tensors live on the
mesh's devices and halos travel as tensor copies between them.
"""
