"""Collectives of the port: the reference's ICI tier over
``torch.distributed`` (``comm/ici.py``)."""
