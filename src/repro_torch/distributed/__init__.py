"""The port's mesh layer (counterpart of ``repro/distributed``): the
sharding rules (``sharding.py``) and the registered mesh that in-model
constraints read (``ctx.py``)."""
