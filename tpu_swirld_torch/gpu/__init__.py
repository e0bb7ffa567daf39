"""The port's device layer: hand-written CUDA kernels (``csrc/``), their
build (``build.py``), their wrappers and plain versions (``kernels.py``) and
the column-restricted consensus pipeline (``pipeline.py``)."""
