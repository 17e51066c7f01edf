"""RF and FSO link budgets (paper §II-B, Eq. 5-13) and delay model (Eq. 7).

Table I parameters are the defaults. The paper deliberately tunes FSO
parameters so FSO links behave like the RF links (fair comparison with
GS-based baselines); we keep both the physics and that calibration knob.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.orbits.constellation import SPEED_OF_LIGHT

BOLTZMANN = 1.380649e-23


@dataclasses.dataclass(frozen=True)
class RfLinkParams:
    """Table I, RF column."""
    antenna_gain_dbi: float = 6.98      # G, sender & receiver
    tx_power_dbm: float = 40.0          # P_t
    carrier_freq_hz: float = 2.4e9      # f
    noise_temp_k: float = 354.81        # T
    bandwidth_hz: float = 500_000.0     # B — chosen so R ~= 16 Mb/s at
                                        # typical LEO-GS ranges (Table I R)
    fixed_rate_bps: float | None = 16e6  # Table I pins R = 16 Mb/s


@dataclasses.dataclass(frozen=True)
class FsoLinkParams:
    """Table I, FSO column + Eq. 9-13 constants."""
    tx_power_dbm: float = 10.0
    carrier_freq_hz: float = 2.4e9       # paper reuses f for fair comparison
    radiation_coeff: float = 1.0         # sigma (Lambertian order)
    detector_area_m2: float = 1e-2       # A_0
    viewing_angle_rad: float = 0.0       # alpha_e
    filter_transmission: float = 1.0     # T_f
    concentration_gain: float = 1.0      # g(theta)
    incident_angle_rad: float = 0.0      # theta
    responsivity: float = 0.8            # rho
    noise_variance: float = 1e-13        # N
    bandwidth_hz: float = 500_000.0
    wind_speed_kms: float = 0.021        # V (Table I)
    aperture_radius_m: float = 0.05      # r (Eq. 11)
    divergence_angle_rad: float = 1e-3   # xi (Eq. 11)
    fixed_rate_bps: float | None = 16e6  # calibrated to match RF (paper §IV)


RF_DEFAULTS = RfLinkParams()
FSO_DEFAULTS = FsoLinkParams()


def _db_to_lin(db: float) -> float:
    return 10.0 ** (db / 10.0)


def free_space_path_loss(distance_m: float | np.ndarray, freq_hz: float):
    """Eq. 6: L = (4*pi*d*f/c)^2."""
    d = np.asarray(distance_m, dtype=np.float64)
    return (4.0 * math.pi * d * freq_hz / SPEED_OF_LIGHT) ** 2


def rf_snr(distance_m: float | np.ndarray, p: RfLinkParams = RF_DEFAULTS):
    """Eq. 5: SNR = P_t G_a G_b / (k_B T B L)."""
    pt_w = _db_to_lin(p.tx_power_dbm) * 1e-3
    g = _db_to_lin(p.antenna_gain_dbi)
    loss = free_space_path_loss(distance_m, p.carrier_freq_hz)
    noise = BOLTZMANN * p.noise_temp_k * p.bandwidth_hz
    return pt_w * g * g / (noise * loss)


def fso_channel_gain(distance_m: float | np.ndarray, p: FsoLinkParams = FSO_DEFAULTS):
    """Eq. 9 Lambertian LoS optical channel gain."""
    d = np.asarray(distance_m, dtype=np.float64)
    sigma = p.radiation_coeff
    return (
        (sigma + 1.0)
        / (2.0 * math.pi * d**2)
        * p.detector_area_m2
        * np.cos(p.viewing_angle_rad) ** sigma
        * p.filter_transmission
        * p.concentration_gain
        * np.cos(p.incident_angle_rad)
    )


def fso_geometric_loss(distance_m: float | np.ndarray, p: FsoLinkParams = FSO_DEFAULTS):
    """Eq. 11: l_g = 4*pi*r^2 / (pi * (xi * d)^2)  (fraction of power kept)."""
    d = np.asarray(distance_m, dtype=np.float64)
    return 4.0 * math.pi * p.aperture_radius_m**2 / (
        math.pi * (p.divergence_angle_rad * d) ** 2
    )


def hufnagel_valley_cn2(altitude_m: float | np.ndarray, wind_speed_kms: float = 0.021):
    """Eq. 12: refractive-index structure parameter M^2(z) (H-V model).

    The paper states wind speed in km/s (Table I); H-V expects m/s — we
    convert. K = 1.7e-14 m^{-2/3}.
    """
    z = np.asarray(altitude_m, dtype=np.float64)
    v_ms = wind_speed_kms * 1000.0
    term1 = (
        0.00594 * (v_ms / 27.0) ** 2 * (1e-5 * z) ** 10 * np.exp(-z / 1000.0)
    )
    term2 = 2.7e-16 * np.exp(-z / 1500.0)
    term3 = 1.7e-14 * np.exp(-z / 100.0)
    return term1 + term2 + term3


def fso_turbulence_loss(
    distance_m: float | np.ndarray,
    altitude_m: float,
    p: FsoLinkParams = FSO_DEFAULTS,
):
    """Eq. 13 (Rytov-variance-style scintillation loss, in dB-equivalent)."""
    d = np.asarray(distance_m, dtype=np.float64)
    cn2 = hufnagel_valley_cn2(altitude_m, p.wind_speed_kms)
    k_wave = 2.0 * math.pi * p.carrier_freq_hz / SPEED_OF_LIGHT * 1e9
    return np.sqrt(23.17 * k_wave ** (7.0 / 6.0) * cn2 * d ** (11.0 / 6.0))


def fso_snr(
    distance_m: float | np.ndarray,
    altitude_m: float = 20_000.0,
    p: FsoLinkParams = FSO_DEFAULTS,
):
    """Eq. 10: SNR = (rho G P_t)^2 B / (N R), with geometric + turbulence
    attenuation applied to the received optical power."""
    pt_w = _db_to_lin(p.tx_power_dbm) * 1e-3
    gain = fso_channel_gain(distance_m, p)
    atten = np.minimum(fso_geometric_loss(distance_m, p), 1.0)
    turb_db = fso_turbulence_loss(distance_m, altitude_m, p)
    turb = 10.0 ** (-np.minimum(turb_db, 100.0) / 10.0)
    rx = p.responsivity * gain * pt_w * atten * turb
    rate = p.fixed_rate_bps or p.bandwidth_hz
    return rx**2 * p.bandwidth_hz / (p.noise_variance * rate)


def shannon_rate_bps(snr: float | np.ndarray, bandwidth_hz: float):
    """Eq. 8: R ~= B log2(1 + SNR)."""
    return bandwidth_hz * np.log2(1.0 + np.asarray(snr, dtype=np.float64))


def link_rate_bps(
    distance_m: float | np.ndarray,
    kind: str = "rf",
    rf: RfLinkParams = RF_DEFAULTS,
    fso: FsoLinkParams = FSO_DEFAULTS,
    altitude_m: float = 20_000.0,
) -> float | np.ndarray:
    """Effective data rate for a link. Table I pins R = 16 Mb/s for the
    paper's experiments (both link types, for fairness); passing
    fixed_rate_bps=None computes the Shannon rate from the SNR instead.

    Vectorized over ``distance_m`` (scalar in -> float out, array in ->
    array out) so delay *tables* over whole visibility grids are one
    evaluation."""
    scalar = np.ndim(distance_m) == 0
    d = np.asarray(distance_m, dtype=np.float64)
    if kind == "rf":
        rate = (np.full(d.shape, rf.fixed_rate_bps)
                if rf.fixed_rate_bps is not None
                else shannon_rate_bps(rf_snr(d, rf), rf.bandwidth_hz))
    elif kind == "fso":
        rate = (np.full(d.shape, fso.fixed_rate_bps)
                if fso.fixed_rate_bps is not None
                else shannon_rate_bps(fso_snr(d, altitude_m, fso),
                                      fso.bandwidth_hz))
    else:
        raise ValueError(f"unknown link kind: {kind}")
    return float(rate) if scalar else rate


def link_delay_s(
    payload_bits: float,
    distance_m: float | np.ndarray,
    kind: str = "rf",
    processing_delay_s: float = 0.05,
    rf: RfLinkParams = RF_DEFAULTS,
    fso: FsoLinkParams = FSO_DEFAULTS,
) -> float | np.ndarray:
    """Eq. 7: t_d = z|D|/R  +  d/c  +  t_a + t_b.

    transmission + propagation + (sender + receiver processing).
    Vectorized over ``distance_m`` like :func:`link_rate_bps`.
    """
    rate = link_rate_bps(distance_m, kind, rf, fso)
    t_t = payload_bits / rate
    t_p = distance_m / SPEED_OF_LIGHT
    return t_t + t_p + 2.0 * processing_delay_s


def model_transfer_delay_s(
    num_params: int,
    distance_m: float | np.ndarray,
    kind: str = "rf",
    bits_per_param: int = 32,
    processing_delay_s: float = 0.05,
) -> float | np.ndarray:
    """Delay to ship a model of `num_params` parameters over a link."""
    return link_delay_s(
        float(num_params) * bits_per_param, distance_m, kind,
        processing_delay_s,
    )
