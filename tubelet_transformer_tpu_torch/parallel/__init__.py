"""Multi-device runtime of the port: data parallelism over
``torch.distributed`` (``mesh.py``) and ZeRO-1, the AdamW moments sharded
over the 'data' axis (``zero.py``)."""
