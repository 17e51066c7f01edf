"""Serve a (reduced) assigned architecture with batched greedy decoding on
the PyTorch/CUDA port, including the SSM O(1)-state path:
``examples/serve_constellation.py`` on ``repro_torch``. It runs on the
card; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/serve_constellation_torch.py
  PYTHONPATH=src python examples/serve_constellation_torch.py --device cpu

The flags are ``repro_torch.launch.serve``'s. Flags given here are read
after the reference's defaults (``--arch rwkv6-3b --batch 4 --prompt-len
12 --gen 20``), so each replaces only its own default.
"""
import sys

from repro_torch.launch.serve import main as serve_main

DEFAULTS = ["--arch", "rwkv6-3b", "--batch", "4", "--prompt-len", "12",
            "--gen", "20"]


def main(argv=None):
    """Serve with ``DEFAULTS`` then ``argv``; returns the tokens (B, P +
    gen) that ``repro_torch.launch.serve.main`` returns."""
    return serve_main(DEFAULTS + list(sys.argv[1:] if argv is None
                                      else argv))


if __name__ == "__main__":
    main()
