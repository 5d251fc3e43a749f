"""Per-region sustainability telemetry — calibrated synthetic time series.

The paper feeds WaterWise live data (Electricity Maps carbon intensity + energy
mix, Meteologix wet-bulb temperature -> WUE, ourworldindata WSF, Macknick EWIF
per energy source). This container is offline, so we generate the same signals
from a *physical* model that is calibrated to the paper's published numbers:

* Fig 1 per-source constants: coal CI=1050 gCO2/kWh (62x hydro's 17);
  hydro EWIF=17 L/kWh (11x coal's ~1.5).
* Fig 2 per-region orderings: Zurich lowest CI / highest EWIF; Mumbai highest
  CI / low EWIF; Madrid & Mumbai & Oregon high WSF, Zurich low.
* Fig 2(e) temporal structure: diurnal solar swing + synoptic (multi-day)
  weather noise => periods of high-CI/low-WI and vice versa.

The generator works by evolving each region's *energy mix shares* hourly and
deriving CI(t) = sum share_s * CI_s and EWIF(t) = sum share_s * EWIF_s — so the
carbon/water tension emerges from the physics (hydro & biomass are low-carbon
but water-thirsty) rather than being painted on. WUE(t) is a cooling-tower
model of wet-bulb temperature. Two EWIF tables are shipped: ``MACKNICK``
(Electricity-Maps-era, used by paper Fig 5) and ``WRI`` (paper Fig 6
sensitivity study).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

import repro_torch.obs as obs
from repro_torch.core import footprint

HOUR = 3600.0

# ---------------------------------------------------------------------------
# Per-source constants (paper Fig 1; Macknick et al. + IPCC Annex III)
# CI in gCO2/kWh; EWIF in L/kWh.
# ---------------------------------------------------------------------------

SOURCE_CI: Dict[str, float] = {
    "coal": 1050.0,
    "oil": 720.0,
    "gas": 490.0,
    "biomass": 230.0,
    "solar": 45.0,
    "hydro": 17.0,
    "nuclear": 12.0,
    "wind": 11.0,
}

# Macknick operational-consumption factors (tower-cooled medians), the dataset
# the paper uses with Electricity Maps mixes.
EWIF_MACKNICK: Dict[str, float] = {
    "coal": 1.55,      # paper: hydro 17 is "11x" coal
    "oil": 1.60,
    "gas": 1.00,
    "biomass": 25.0,   # feedstock irrigation + cooling
    "solar": 0.30,     # PV wash water
    "hydro": 17.0,     # paper Fig 1
    "nuclear": 2.30,
    "wind": 0.01,
}

# WRI "Guidance for calculating water use embedded in purchased electricity"
# (paper Fig 6 sensitivity): same ordering, different magnitudes.
EWIF_WRI: Dict[str, float] = {
    "coal": 1.90,
    "oil": 1.75,
    "gas": 0.75,
    "biomass": 32.0,
    "solar": 0.10,
    "hydro": 9.0,
    "nuclear": 2.70,
    "wind": 0.005,
}

EWIF_TABLES = {"macknick": EWIF_MACKNICK, "wri": EWIF_WRI}


# ---------------------------------------------------------------------------
# Regions (paper §5: five AWS regions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RegionSpec:
    name: str
    aws: str
    # Mean energy-mix shares (sum to 1); solar share swings diurnally.
    mix: Dict[str, float]
    wsf: float                      # water scarcity factor (Fig 2d)
    pue: float                      # §5: PUE = 1.2 everywhere by default
    wb_mean_c: float                # mean wet-bulb temperature, deg C
    wb_diurnal_c: float             # diurnal wet-bulb amplitude
    wb_synoptic_c: float            # multi-day weather amplitude
    utc_offset_h: float             # phase of local solar noon
    mix_volatility: float = 0.10    # synoptic share-shuffle magnitude


REGIONS: List[RegionSpec] = [
    # Zurich: hydro+nuclear+biomass -> lowest CI, highest EWIF (paper Fig 2a/2b)
    RegionSpec("Zurich", "eu-central-2",
               {"hydro": 0.48, "nuclear": 0.28, "biomass": 0.12,
                "solar": 0.07, "gas": 0.05},
               wsf=0.10, pue=1.2, wb_mean_c=9.0, wb_diurnal_c=3.5,
               wb_synoptic_c=4.0, utc_offset_h=1.0),
    # Oregon: hydro-heavy + gas; low-ish CI, mid EWIF, HIGH WSF (paper Fig 2d)
    RegionSpec("Oregon", "us-west-2",
               {"hydro": 0.42, "gas": 0.28, "wind": 0.14, "solar": 0.07,
                "coal": 0.05, "nuclear": 0.04},
               wsf=0.55, pue=1.2, wb_mean_c=12.0, wb_diurnal_c=5.0,
               wb_synoptic_c=5.0, utc_offset_h=-8.0),
    # Madrid: renewables-forward but water stressed (paper's key example)
    RegionSpec("Madrid", "eu-south-2",
               {"wind": 0.24, "solar": 0.19, "nuclear": 0.21, "gas": 0.24,
                "hydro": 0.10, "coal": 0.02},
               wsf=0.80, pue=1.2, wb_mean_c=14.0, wb_diurnal_c=5.5,
               wb_synoptic_c=4.5, utc_offset_h=1.0),
    # Milan: gas-dominated
    RegionSpec("Milan", "eu-south-1",
               {"gas": 0.46, "hydro": 0.18, "solar": 0.10, "wind": 0.05,
                "nuclear": 0.11, "coal": 0.06, "biomass": 0.04},
               wsf=0.35, pue=1.2, wb_mean_c=15.0, wb_diurnal_c=4.5,
               wb_synoptic_c=4.0, utc_offset_h=1.0),
    # Mumbai: coal-dominated -> highest CI, LOW EWIF, high WSF (Fig 2)
    RegionSpec("Mumbai", "ap-south-1",
               {"coal": 0.68, "gas": 0.12, "hydro": 0.06, "wind": 0.07,
                "solar": 0.06, "oil": 0.01},
               wsf=0.90, pue=1.2, wb_mean_c=24.0, wb_diurnal_c=2.5,
               wb_synoptic_c=2.0, utc_offset_h=5.5),
]

REGION_NAMES = [r.name for r in REGIONS]
REGION_INDEX = {r.name: i for i, r in enumerate(REGIONS)}


# ---------------------------------------------------------------------------
# Inter-region WAN model (paper Table 3: transfer latency dominates the
# communication cost; home Oregon -> {Zurich, Madrid, Milan, Mumbai}).
# Effective long-haul throughput per transfer stream, plus RTT.
# ---------------------------------------------------------------------------

WAN_BW_GBPS = np.array([
    #  Zur   Ore   Mad   Mil   Mum
    [0.0, 0.9, 2.4, 2.8, 0.7],   # Zurich
    [0.9, 0.0, 1.0, 0.9, 0.5],   # Oregon
    [2.4, 1.0, 0.0, 2.2, 0.6],   # Madrid
    [2.8, 0.9, 2.2, 0.0, 0.7],   # Milan
    [0.7, 0.5, 0.6, 0.7, 0.0],   # Mumbai
])  # GB/s effective; diagonal unused

WAN_RTT_S = np.array([
    [0.000, 0.140, 0.030, 0.012, 0.110],
    [0.140, 0.000, 0.150, 0.155, 0.220],
    [0.030, 0.150, 0.000, 0.028, 0.125],
    [0.012, 0.155, 0.028, 0.000, 0.105],
    [0.110, 0.220, 0.125, 0.105, 0.000],
])


def transfer_latency_s(bytes_: float, src: int, dst: int,
                       fixed_overhead_s: float = 2.0) -> float:
    """Job-package / checkpoint transfer time between regions (paper: SCP .tar;
    ours: sharded checkpoint). ``src == dst`` -> 0."""
    if src == dst:
        return 0.0
    bw = WAN_BW_GBPS[src, dst] * 1e9
    return fixed_overhead_s + WAN_RTT_S[src, dst] + bytes_ / bw


# ---------------------------------------------------------------------------
# WUE model: counterflow cooling-tower water evaporation as a function of
# wet-bulb temperature (deg C) -> L/kWh. Piecewise-smooth fit used by
# Li et al. ("Making AI less thirsty" [32]), clipped to physical range.
# ---------------------------------------------------------------------------

def wue_from_wetbulb(t_wb_c: np.ndarray) -> np.ndarray:
    t = np.asarray(t_wb_c, dtype=np.float64)
    wue = 6e-5 * t**3 - 0.01 * t**2 + 0.61 * t - 10.4
    return np.clip(wue / 3.6, 0.05, 9.0)  # /3.6: MJ->kWh units of the fit


# ---------------------------------------------------------------------------
# Time-series generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Telemetry:
    """Hourly telemetry for all regions over a horizon.

    Attributes (all np.ndarray, shape [T, R] unless noted):
      ci          gCO2/kWh grid carbon intensity
      ewif        L/kWh grid energy-water-intensity
      wue         L/kWh onsite cooling water usage effectiveness
      wsf         [R] water scarcity factor (static)
      pue         [R] power usage effectiveness (static)
      water_int   Eq (6) water intensity, L/kWh
      hours       [T] hour index
      wb_c        [T, R] wet-bulb temperature, °C (the raw weather driving
                  WUE; kept because WUE clips at its physical floor, so heat
                  extremes are only visible in the wet-bulb series itself)
    """
    ci: np.ndarray
    ewif: np.ndarray
    wue: np.ndarray
    wsf: np.ndarray
    pue: np.ndarray
    hours: np.ndarray
    wb_c: Optional[np.ndarray] = None
    # [R, R] WAN tables for *this* telemetry's regions. ``generate`` slices
    # the global tables by region identity (name lookup), so ablation runs
    # on a non-prefix subset — e.g. {Zurich, Milan, Mumbai} — price a
    # Zurich→Mumbai transfer with Mumbai's bandwidth/RTT, not whatever
    # region happens to occupy the same local index. None falls back to the
    # leading-N slice of the global tables.
    bw_gbps: Optional[np.ndarray] = None
    rtt_s: Optional[np.ndarray] = None

    @property
    def num_hours(self) -> int:
        return self.ci.shape[0]

    @property
    def num_regions(self) -> int:
        return self.ci.shape[1]

    @property
    def wan_bw_gbps(self) -> np.ndarray:
        if self.bw_gbps is not None:
            return self.bw_gbps
        return WAN_BW_GBPS[:self.num_regions, :self.num_regions]

    @property
    def wan_rtt_s(self) -> np.ndarray:
        if self.rtt_s is not None:
            return self.rtt_s
        return WAN_RTT_S[:self.num_regions, :self.num_regions]

    def transfer_latency_s(self, bytes_: float, src: int, dst: int,
                           fixed_overhead_s: float = 2.0) -> float:
        """Region-identity-aware variant of module-level
        ``transfer_latency_s`` — schedulers and engines must price transfers
        with *this* telemetry's WAN tables so subset runs stay consistent."""
        if src == dst:
            return 0.0
        bw = max(self.wan_bw_gbps[src, dst] * 1e9, 1.0)
        return fixed_overhead_s + self.wan_rtt_s[src, dst] + bytes_ / bw

    @property
    def water_intensity(self) -> np.ndarray:
        return footprint.water_intensity(self.wue, self.pue[None, :],
                                         self.ewif, self.wsf[None, :])

    def at(self, t_s: float) -> Dict[str, np.ndarray]:
        """Telemetry snapshot at absolute time ``t_s`` (linear interpolation
        between hourly samples — grid signals vary continuously; wraps
        around the horizon so long simulations never run off the end)."""
        h = int(t_s // HOUR) % self.num_hours
        h2 = (h + 1) % self.num_hours
        w = (t_s % HOUR) / HOUR
        mix = lambda a: (1 - w) * a[h] + w * a[h2]
        ci, ewif, wue = mix(self.ci), mix(self.ewif), mix(self.wue)
        return dict(ci=ci, ewif=ewif, wue=wue, wsf=self.wsf, pue=self.pue,
                    water_intensity=footprint.water_intensity(
                        wue, self.pue, ewif, self.wsf))

    def mean_between(self, t0_s: float, t1_s: float) -> Dict[str, np.ndarray]:
        """Time-mean of (ci, ewif, wue) over [t0, t1] on the interpolated
        signal (trapezoid over ≤10-minute sub-samples)."""
        n = max(int((t1_s - t0_s) // 600), 1) + 1
        ts = np.linspace(t0_s, max(t1_s, t0_s + 1.0), n + 1)
        snaps = [self.at(float(t)) for t in ts]
        out = {}
        for k in ("ci", "ewif", "wue"):
            vals = np.stack([s[k] for s in snaps])
            out[k] = (0.5 * (vals[:-1] + vals[1:])).mean(axis=0)
        return out

    def index(self, t_s: float) -> int:
        return int(t_s // HOUR) % self.num_hours

    # -- vectorized exact integration (event-driven engine hot path) --------

    def _cumulative(self) -> Dict[str, np.ndarray]:
        """Lazily built per-signal cumulative trapezoid integrals.

        ``cum[k]`` is ∫ over the first k hourly segments of the interpolated
        (piecewise-linear, periodic) signal, in value·hours, shape [T+1, R].
        The signal wraps (segment T-1 interpolates toward sample 0), matching
        ``at``.
        """
        cache = getattr(self, "_cum_cache", None)
        if cache is None:
            cache = {}
            for key in ("ci", "ewif", "wue"):
                x = getattr(self, key)
                xw = np.vstack([x, x[:1]])                    # wrap sample
                seg = 0.5 * (xw[:-1] + xw[1:])                # [T, R]
                cache[key] = np.vstack([np.zeros((1, x.shape[1])),
                                        np.cumsum(seg, axis=0)])
            self._cum_cache = cache
        return cache

    def _antiderivative(self, key: str, t_s: np.ndarray) -> np.ndarray:
        """F(t) = ∫_0^t x(τ) dτ on the periodic interpolated signal,
        vectorized: t_s [K] → [K, R] in value·seconds."""
        x = getattr(self, key)
        cum = self._cumulative()[key]
        T = self.num_hours
        period_s = T * HOUR
        t = np.asarray(t_s, np.float64)
        m = np.floor(t / period_s)
        h = (t - m * period_s) / HOUR
        k = np.minimum(h.astype(np.int64), T - 1)
        frac = (h - k)[..., None]
        xw = np.vstack([x, x[:1]])
        x0, x1 = xw[k], xw[k + 1]
        part = cum[k] + x0 * frac + 0.5 * (x1 - x0) * frac ** 2
        return (m[..., None] * cum[T] + part) * HOUR

    def mean_over(self, t0_s: np.ndarray, t1_s: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        """Exact closed-form time-means of (ci, ewif, wue) over [t0, t1],
        vectorized over K intervals → dict of [K, R] arrays.

        This is the batch counterpart of ``mean_between``: that method
        approximates the integral with ≤10-minute trapezoid sub-samples per
        call; this one integrates the piecewise-linear signal exactly and
        amortizes across all intervals at once (the event-driven engine
        accounts every job of a run in a single call)."""
        t0 = np.asarray(t0_s, np.float64)
        t1 = np.maximum(np.asarray(t1_s, np.float64), t0 + 1.0)
        dt = (t1 - t0)[..., None]
        return {key: (self._antiderivative(key, t1)
                      - self._antiderivative(key, t0)) / dt
                for key in ("ci", "ewif", "wue")}

    def at_many(self, t_s: np.ndarray) -> Dict[str, np.ndarray]:
        """Vectorized ``at``: snapshots at K times → dict of [K, R]."""
        T = self.num_hours
        t = np.asarray(t_s, np.float64)
        h = (t // HOUR).astype(np.int64) % T
        h2 = (h + 1) % T
        w = ((t % HOUR) / HOUR)[..., None]
        out = {}
        for key in ("ci", "ewif", "wue"):
            x = getattr(self, key)
            out[key] = (1 - w) * x[h] + w * x[h2]
        return out


def _solar_profile(hours_utc: np.ndarray, utc_offset_h: float) -> np.ndarray:
    """Daylight factor in [0, 1]: 0 at night, peak at local solar noon."""
    local = (hours_utc + utc_offset_h) % 24.0
    return np.clip(np.sin((local - 6.0) / 12.0 * np.pi), 0.0, None)


def _smooth_noise(rng: np.random.Generator, n: int, corr_hours: float,
                  amp: float) -> np.ndarray:
    """Ornstein-Uhlenbeck-ish smooth noise with given correlation time."""
    alpha = 1.0 / max(corr_hours, 1.0)
    x = np.zeros(n)
    w = rng.standard_normal(n)
    for i in range(1, n):
        x[i] = (1 - alpha) * x[i - 1] + np.sqrt(2 * alpha) * w[i] * amp
    return x


def generate(days: int = 10, seed: int = 0, ewif_table: str = "macknick",
             regions: Sequence[RegionSpec] = tuple(REGIONS)) -> Telemetry:
    """Generate hourly telemetry for ``days`` days across ``regions``."""
    table = EWIF_TABLES[ewif_table]
    rng = np.random.default_rng(seed)
    T = days * 24
    R = len(regions)
    hours = np.arange(T, dtype=np.float64)

    ci = np.zeros((T, R))
    ewif = np.zeros((T, R))
    wue = np.zeros((T, R))
    wb = np.zeros((T, R))
    wsf = np.array([r.wsf for r in regions])
    pue = np.array([r.pue for r in regions])

    sources = sorted(SOURCE_CI)
    for ri, reg in enumerate(regions):
        base = np.array([reg.mix.get(s, 0.0) for s in sources])
        solar_ix = sources.index("solar")
        gas_ix = sources.index("gas")
        hydro_ix = sources.index("hydro")

        solar = _solar_profile(hours, reg.utc_offset_h)
        # Synoptic share noise: hydro/wind availability drifts over days.
        drift = _smooth_noise(rng, T, corr_hours=36.0, amp=reg.mix_volatility)

        shares = np.tile(base, (T, 1))
        # Solar swings with daylight: night solar -> displaced by gas.
        solar_gain = base[solar_ix] * (1.6 * solar - 0.8)
        shares[:, solar_ix] = np.clip(base[solar_ix] + solar_gain, 0.0, None)
        shares[:, gas_ix] = np.clip(base[gas_ix] - solar_gain, 0.02, None)
        # Hydro drifts synoptically; compensated by gas.
        hydro_d = base[hydro_ix] * drift
        shares[:, hydro_ix] = np.clip(base[hydro_ix] + hydro_d, 0.0, None)
        shares[:, gas_ix] = np.clip(shares[:, gas_ix] - hydro_d, 0.02, None)
        shares /= shares.sum(axis=1, keepdims=True)

        ci_src = np.array([SOURCE_CI[s] for s in sources])
        ewif_src = np.array([table[s] for s in sources])
        ci[:, ri] = shares @ ci_src
        ewif[:, ri] = shares @ ewif_src

        # Wet-bulb temperature -> WUE.
        t_wb = (reg.wb_mean_c
                + reg.wb_diurnal_c * np.sin((hours + reg.utc_offset_h - 9.0)
                                            / 24.0 * 2 * np.pi)
                + _smooth_noise(rng, T, corr_hours=48.0, amp=reg.wb_synoptic_c))
        wue[:, ri] = wue_from_wetbulb(t_wb)
        wb[:, ri] = t_wb

    # WAN tables by region *identity*: known region names map to their rows
    # in the global tables (so non-prefix subsets keep the right pairs);
    # unknown/custom regions borrow a not-yet-used global row as a proxy.
    # Any off-diagonal cell two regions end up sharing (only possible with
    # > len(REGIONS) custom regions) would land on the unused zero diagonal,
    # so those cells are patched to the fleet-typical link instead.
    used = {REGION_INDEX[r.name] for r in regions if r.name in REGION_INDEX}
    free = iter(i for i in range(len(REGIONS)) if i not in used)
    ids = np.array([REGION_INDEX[r.name] if r.name in REGION_INDEX
                    else next(free, i % len(REGIONS))
                    for i, r in enumerate(regions)])
    bw_sub = WAN_BW_GBPS[np.ix_(ids, ids)].copy()
    rtt_sub = WAN_RTT_S[np.ix_(ids, ids)].copy()
    off_diag = ~np.eye(len(ids), dtype=bool)
    degenerate = off_diag & (bw_sub <= 0.0)
    if degenerate.any():
        bw_sub[degenerate] = float(WAN_BW_GBPS[WAN_BW_GBPS > 0].mean())
        rtt_sub[degenerate] = float(WAN_RTT_S[WAN_RTT_S > 0].mean())
        obs.warn("telemetry.degenerate_wan",
                 f"{int(degenerate.sum())} region-pair WAN cells had no "
                 "bandwidth entry; patched to the fleet-typical link")
    return Telemetry(ci=ci, ewif=ewif, wue=wue, wsf=wsf, pue=pue, hours=hours,
                     wb_c=wb, bw_gbps=bw_sub, rtt_s=rtt_sub)
