"""Orbital mechanics, visibility geometry, link budgets and ISL routing
(numpy copies of ``repro.orbits``).

The routing subsystem (:mod:`repro_torch.orbits.routing`: time-expanded
ISL contact graphs, earliest-arrival search, stitched window chains and
sink elections) is the substrate of the routed strategies (fedsink,
fedhap_async, fedhap_buffered).
"""
from repro_torch.orbits.constellation import (
    EARTH_RADIUS_M,
    MU_EARTH,
    MultiShellConstellation,
    Satellite,
    ShellSpec,
    WalkerConstellation,
    ephemeris_positions_eci,
    orbital_period_s,
    orbital_speed_ms,
    parse_shells,
    station_positions_eci,
)
from repro_torch.orbits.visibility import (
    Station,
    effective_min_elevation_deg,
    elevation_angle_deg,
    is_visible,
    isl_mask_from_positions,
    isl_pairs_visible,
    iter_distance_chunks,
    mask_from_positions,
    next_contact_table,
    sat_sat_visibility_mask,
    sat_sat_visible,
    stations_eci,
    visibility_mask,
    visibility_mask_pairwise,
    visibility_windows,
    windows_from_mask,
)
from repro_torch.orbits.routing import (
    ContactGraph,
    SinkElection,
    SparseContactGraph,
    WindowedRouter,
    build_contact_graph,
    earliest_arrival,
    earliest_arrival_dense,
    earliest_arrival_reference,
    elect_sinks,
    extract_path,
    extract_paths,
    predecessors,
)
from repro_torch.orbits.links import (
    FSO_DEFAULTS,
    RF_DEFAULTS,
    FsoLinkParams,
    RfLinkParams,
    fso_channel_gain,
    fso_snr,
    link_delay_s,
    model_transfer_delay_s,
    rf_snr,
    shannon_rate_bps,
)

__all__ = [
    "EARTH_RADIUS_M", "MU_EARTH", "MultiShellConstellation", "Satellite",
    "ShellSpec", "WalkerConstellation",
    "ephemeris_positions_eci", "orbital_period_s", "orbital_speed_ms",
    "parse_shells", "station_positions_eci",
    "Station", "effective_min_elevation_deg", "elevation_angle_deg",
    "is_visible", "isl_mask_from_positions", "isl_pairs_visible",
    "iter_distance_chunks",
    "mask_from_positions", "next_contact_table",
    "sat_sat_visibility_mask", "sat_sat_visible", "stations_eci",
    "visibility_mask", "visibility_mask_pairwise", "visibility_windows",
    "windows_from_mask",
    "ContactGraph", "SinkElection", "SparseContactGraph", "WindowedRouter",
    "build_contact_graph", "earliest_arrival", "earliest_arrival_dense",
    "earliest_arrival_reference", "elect_sinks",
    "extract_path", "extract_paths", "predecessors",
    "FSO_DEFAULTS", "RF_DEFAULTS", "FsoLinkParams", "RfLinkParams",
    "fso_channel_gain", "fso_snr", "link_delay_s", "model_transfer_delay_s",
    "rf_snr", "shannon_rate_bps",
]
