"""The model zoo's ported part: config, layers, MLPs, attention (with the
``swa`` kernel on windowed blocks), the RG-LRU block (with the ``rglru``
kernel) and the transformer stack's train-mode forward and ``encode``."""
