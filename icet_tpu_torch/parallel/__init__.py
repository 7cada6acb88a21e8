"""Parallel execution of the port: the in-process device mesh
(:mod:`.sharding`), the multi-process mesh over ``torch.distributed``
(:mod:`.distributed`) and device-loss handling (:mod:`.elastic`)."""
