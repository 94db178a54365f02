"""Multi-device execution: device meshes (``mesh``), the halo-exchanged
domain decomposition of the step over them (``halo``), the multi-process
bootstrap (``multihost``) and batches of independent decks (``batch``).

The counterpart of ``advanced_hpc_lbm_tpu.parallel``.  A process drives
every shard it owns: per-shard tensors live on the mesh's devices and halos
travel as tensor copies between them, or, between two processes of a
``torch.distributed`` group, as sends and receives.
"""
