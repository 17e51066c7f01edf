"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions, and the wrappers the simulator and the LM call (``ops``).

Kernels:
- ``fedagg`` — weighted multi-replica parameter fold (the FedHAP hot
  loop), CUDA C++ for sm_90a; replaces ``repro/kernels/fedagg.py:30``.
- ``flash_attention`` — causal / windowed GQA attention forward (the LM
  prefill and training), CUDA C++ for sm_90a; replaces
  ``repro/kernels/flash_attention.py:87``; and its backward
  (``csrc/flash_attention_bwd.cu``, LM training), the port's own: the
  JAX package differentiates a jnp analogue instead.
- ``selective_scan`` — the Mamba selective-SSM recurrence (the jamba
  prefill and training), CUDA C++ for sm_90a; replaces
  ``repro/kernels/selective_scan.py:42``; and its backward
  (``csrc/selective_scan_bwd.cu``), the port's own.
- ``rwkv6_wkv`` — the RWKV-6 WKV recurrence (the RWKV prefill and
  training), CUDA C++ for sm_90a; replaces
  ``repro/kernels/rwkv6_wkv.py:47``; and its backward
  (``csrc/rwkv6_wkv_bwd.cu``), the port's own.

``flash_attention``, ``selective_scan`` and ``rwkv6_wkv`` differentiate
through their backward kernels (``FlashAttentionFn``,
``SelectiveScanFn``, ``RwkvWkvFn``). The fold is forward only: its
wrappers refuse an input that requires grad while grad is enabled
(``guard``), so no gradient is dropped silently.
"""
