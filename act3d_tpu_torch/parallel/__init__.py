"""Data parallelism and FSDP over a (dp, fsdp) device mesh (``mesh.py``)
and metric aggregation across ranks (``collectives.py``)."""
