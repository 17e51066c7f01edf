"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions, and the wrappers the simulator calls (``ops``).

Kernels:
- ``fedagg`` — weighted multi-replica parameter fold (the FedHAP hot
  loop), CUDA C++ for sm_90a; replaces ``repro/kernels/fedagg.py:30``.
"""
