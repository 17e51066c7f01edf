"""PyTorch/CUDA port of the FedHAP timeline simulator.

Mirrors ``repro`` module for module (``repro.sim.engine`` ->
``repro_torch.sim.engine``). The numpy plan phase is copied and held
bit-equal to the reference by the tests; the execute phase runs on
PyTorch tensors, on the card (``device="cuda"``, the default) unless
the caller asks for ``device="cpu"``. The weighted model fold is a
hand-written CUDA kernel (``repro_torch.kernels``). Imports torch and
numpy only: never jax, never ``repro``.
"""
