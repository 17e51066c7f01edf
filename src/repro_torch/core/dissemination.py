"""Ring schedules shared by the mesh round and the timeline simulator
(port of ``repro.core.dissemination``).

The worker tier lays a point-to-point ring on each orbit (paper §III-A);
the server tier orders HAPs source -> ... -> sink (§III-B1). Directions
are pre-designated (paper: "either clockwise or counter-clockwise").
The mesh rounds (``repro_torch.core.mesh_round``) send along the ring
and chain permutations; the single-device trainer
(``repro_torch.launch.train``) uses the map's layout (orbit-major
satellites, ``sats_per_orbit``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class ConstellationMeshMap:
    """How the constellation maps onto the device mesh (DESIGN.md §8).

    The `data` axis concatenates `n_orbits` contiguous rings of
    `sats_per_orbit` satellites; each pod hosts one HAP and its own
    orbit set.
    """
    n_orbits: int = 4
    sats_per_orbit: int = 4
    n_pods: int = 1

    @classmethod
    def from_constellation(cls, constellation,
                           n_pods: int = 1) -> "ConstellationMeshMap":
        """Mesh map derived from a simulator constellation (anything
        exposing ``num_orbits`` / ``sats_per_orbit``, e.g.
        :class:`repro_torch.orbits.WalkerConstellation`) instead of the
        hardcoded 4x4 default: each pod hosts a contiguous run of
        ``num_orbits / n_pods`` planes."""
        L = int(constellation.num_orbits)
        k = int(constellation.sats_per_orbit)
        if n_pods < 1 or L % n_pods:
            raise ValueError(
                f"cannot split {L} orbit planes over {n_pods} pods: "
                f"each pod must host a whole number of planes")
        return cls(n_orbits=L // n_pods, sats_per_orbit=k, n_pods=n_pods)

    def validate_mesh(self, mesh_shape: Mapping[str, int]) -> None:
        """Raise ValueError when a mesh of axis sizes ``mesh_shape``
        (``{"data": ..., "pod": ...}``) cannot tile this constellation:
        the ``data`` axis must hold exactly one satellite per device
        (``sats_per_pod``) and the ``pod`` axis (when present) exactly
        ``n_pods`` — the layout every ring/chain permutation assumes."""
        shape = dict(mesh_shape)
        data = int(shape.get("data", 0))
        pods = int(shape.get("pod", 1))
        if data != self.sats_per_pod or pods != self.n_pods:
            raise ValueError(
                f"mesh {dict(shape)} cannot tile constellation map "
                f"{self.n_orbits}x{self.sats_per_orbit} x {self.n_pods} "
                f"pod(s): need data={self.sats_per_pod}"
                + (f", pod={self.n_pods}" if self.n_pods > 1 else ""))

    @property
    def sats_per_pod(self) -> int:
        return self.n_orbits * self.sats_per_orbit

    @property
    def total_sats(self) -> int:
        return self.sats_per_pod * self.n_pods

    def orbit_of(self, data_idx: int) -> int:
        return data_idx // self.sats_per_orbit

    def slot_of(self, data_idx: int) -> int:
        return data_idx % self.sats_per_orbit

    def ring_permutation(self, direction: int = +1) -> list[tuple[int, int]]:
        """(src, dst) pairs rotating each orbit ring on the data axis."""
        pairs = []
        k = self.sats_per_orbit
        for d in range(self.sats_per_pod):
            orbit_start = (d // k) * k
            dst = orbit_start + (d % k + direction) % k
            pairs.append((d, dst))
        return pairs


def hap_chain_down(n_pods: int) -> list[tuple[int, int]]:
    """sink -> source direction on the pod axis (partial models, §III-B3)."""
    return [(p, p - 1) for p in range(1, n_pods)]


def hap_chain_up(n_pods: int) -> list[tuple[int, int]]:
    """source -> sink direction (global model, §III-B1)."""
    return [(p, p + 1) for p in range(n_pods - 1)]
