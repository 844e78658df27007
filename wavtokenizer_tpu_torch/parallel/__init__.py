"""Multi-card execution: process groups, the ('data', 'model') mesh, data
parallelism and the ConvNeXt tensor parallelism (``mesh.py``), and
single-process replicas over several devices (``replicas.py``)."""
