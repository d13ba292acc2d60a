"""Multi-device runtime of the port: data parallelism over
``torch.distributed`` (``mesh.py``)."""
