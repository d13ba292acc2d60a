"""Multi-device runtime of the port: data and tensor parallelism over
``torch.distributed`` (``mesh.py``), the split of the transformer and the
MoE experts over the 'model' axis (``sharding_rules.py``) and ZeRO-1, the
AdamW moments sharded over the 'data' axis (``zero.py``)."""
