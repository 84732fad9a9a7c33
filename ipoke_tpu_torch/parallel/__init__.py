"""Parallel training and sampling of the port on ``torch.distributed``
(counterpart of ``ipoke_tpu/parallel/``): process groups and collectives
(``distributed``), the mesh (``mesh``), the sharding rules (``sharding``),
the sequence-parallel motion encoder (``seqpar``) and the dry run of every
leg (``python -m ipoke_tpu_torch.parallel.dryrun``)."""
