"""Multi-card runs over ``torch.distributed``: the process-group mesh and
its collectives (``mesh``), the sharded WVT loop (``wvt_shard``) and the
sharded pipeline stages (``stages``)."""
