"""DEPRECATED shim (port of ``repro.sim.timeline``) — the simulator is
``repro_torch.sim.engine`` + the strategy registry.

``repro_torch.sim`` is the single simulation entry point:

- ``repro_torch.sim.engine`` — :class:`RoundEngine` (=
  ``SatcomSimulator``): world state, contact/route/sink caches, the
  fold, the run loop; ``SimConfig.strategy`` resolves through the
  registry.
- ``repro_torch.sim.strategies`` — registered per-method
  scheduling/weighting rules (fedhap | fedisl | fedisl_ideal | fedsat |
  fedspace | fedsink | fedhap_async | fedhap_buffered).

Every attribute access through this module emits a
:class:`DeprecationWarning` and forwards to the engine (PEP 562), so
``from repro_torch.sim.timeline import SatcomSimulator`` returns the
registry-backed engine class itself.
"""
from __future__ import annotations

import warnings

_FORWARDED = ("RoundEngine", "SatcomSimulator", "SimConfig", "SimResult",
              "_make_stations")

__all__ = list(_FORWARDED)


def __getattr__(name: str):
    if name in _FORWARDED:
        warnings.warn(
            "repro_torch.sim.timeline is deprecated; import from "
            "repro_torch.sim (the RoundEngine + strategy-registry entry "
            "point) instead", DeprecationWarning, stacklevel=2)
        from repro_torch.sim import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
