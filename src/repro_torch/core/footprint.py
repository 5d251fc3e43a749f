"""Carbon- and water-footprint models — paper §2, Eqs (1)-(6), implemented exactly.

All functions are pure and vectorize transparently over numpy arrays, so the
same code path serves (a) the discrete-event simulator (scalar per job), (b) the
MILP cost-matrix construction (jobs × regions matrices), and (c) the JAX solver
(the arrays are duck-typed; jnp arrays pass through unchanged).

Units
-----
energy_kwh     kWh   — job IT-equipment energy E_j
carbon         gCO2
water          L     (scaled by (1+WSF) => "effective liters", per paper Eq 2/3)
ci             gCO2/kWh  — grid carbon intensity
ewif           L/kWh     — energy-water-intensity factor of the grid mix
wue            L/kWh     — water usage effectiveness (cooling, onsite)
pue            (dimensionless) power usage effectiveness
wsf            (dimensionless) water scarcity factor, >= 0
"""
from __future__ import annotations

import dataclasses
from typing import Any

Array = Any  # np.ndarray | jnp.ndarray | float


# ---------------------------------------------------------------------------
# Eq (1): total carbon = operational + embodied
# ---------------------------------------------------------------------------

def operational_carbon(energy_kwh: Array, ci: Array) -> Array:
    """E_j · CO2^Intensity  [gCO2]."""
    return energy_kwh * ci


def embodied_carbon(exec_time_s: Array, lifetime_s: Array,
                    server_embodied_gco2: Array) -> Array:
    """(t_j / T_lifetime) · CO2_server^embodied  [gCO2]."""
    return (exec_time_s / lifetime_s) * server_embodied_gco2


def total_carbon(energy_kwh: Array, ci: Array, exec_time_s: Array,
                 lifetime_s: Array, server_embodied_gco2: Array) -> Array:
    """Eq (1)."""
    return (operational_carbon(energy_kwh, ci)
            + embodied_carbon(exec_time_s, lifetime_s, server_embodied_gco2))


# ---------------------------------------------------------------------------
# Eqs (2)-(5): water footprint
# ---------------------------------------------------------------------------

def offsite_water(energy_kwh: Array, pue: Array, ewif: Array,
                  wsf_dc: Array) -> Array:
    """Eq (2): PUE · E_j · EWIF · (1 + WSF_r^dc)  [L]."""
    return pue * energy_kwh * ewif * (1.0 + wsf_dc)


def onsite_water(energy_kwh: Array, wue: Array, wsf_dc: Array) -> Array:
    """Eq (3): E_j · WUE · (1 + WSF_r^dc)  [L]."""
    return energy_kwh * wue * (1.0 + wsf_dc)


def embodied_water_server(manufacturing_energy_kwh: Array, ewif_mfg: Array,
                          wsf_server: Array) -> Array:
    """Eq (4): E_manufacturing · EWIF · (1 + WSF_r^server)  [L]."""
    return manufacturing_energy_kwh * ewif_mfg * (1.0 + wsf_server)


def embodied_water(exec_time_s: Array, lifetime_s: Array,
                   server_embodied_water_l: Array) -> Array:
    """Job share of the server's embodied water (same amortization as carbon)."""
    return (exec_time_s / lifetime_s) * server_embodied_water_l


def total_water(energy_kwh: Array, pue: Array, ewif: Array, wue: Array,
                wsf_dc: Array, exec_time_s: Array, lifetime_s: Array,
                server_embodied_water_l: Array) -> Array:
    """Eq (5)."""
    return (offsite_water(energy_kwh, pue, ewif, wsf_dc)
            + onsite_water(energy_kwh, wue, wsf_dc)
            + embodied_water(exec_time_s, lifetime_s, server_embodied_water_l))


# ---------------------------------------------------------------------------
# Eq (6): water intensity (the paper's proposed metric)
# ---------------------------------------------------------------------------

def water_intensity(wue: Array, pue: Array, ewif: Array, wsf_dc: Array) -> Array:
    """Eq (6): (WUE + PUE·EWIF) · (1 + WSF_r^dc)  [L/kWh]."""
    return (wue + pue * ewif) * (1.0 + wsf_dc)


# ---------------------------------------------------------------------------
# Server hardware constants (embodied footprints)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """Embodied footprint + power parameters of one server/accelerator node.

    Defaults follow the paper's m5.metal setup (Teads/Davy dataset [13]):
    ~1,344 kgCO2 embodied per m5.metal server, 4-year lifetime. The embodied
    water is derived per Eq (4): embodied carbon / CI_mfg gives manufacturing
    energy; × EWIF_mfg × (1+WSF_mfg) gives liters. For the TPU-adaptation,
    ``tpu_v5e_tray()`` models an 8-chip v5e tray.
    """
    name: str = "m5.metal"
    embodied_gco2: float = 1_344_000.0          # 1,344 kgCO2 -> g
    lifetime_s: float = 4 * 365 * 24 * 3600.0    # 4 years
    ci_mfg_g_per_kwh: float = 550.0              # Taiwan/Korea fab grid mix
    ewif_mfg_l_per_kwh: float = 1.8
    wsf_mfg: float = 0.40                        # fab regions are water-stressed
    idle_power_w: float = 150.0
    peak_power_w: float = 720.0                  # 4-socket Xeon 8175 node

    @property
    def manufacturing_energy_kwh(self) -> float:
        """Back out E_manufacturing from embodied carbon (paper §2.2 method)."""
        return self.embodied_gco2 / self.ci_mfg_g_per_kwh

    @property
    def embodied_water_l(self) -> float:
        """Eq (4) applied to this server."""
        return embodied_water_server(self.manufacturing_energy_kwh,
                                     self.ewif_mfg_l_per_kwh, self.wsf_mfg)


def m5_metal() -> ServerSpec:
    return ServerSpec()


def tpu_v5e_tray() -> ServerSpec:
    """An 8-chip TPU v5e tray (the migration/scheduling unit in our adaptation)."""
    return ServerSpec(
        name="tpu-v5e-8",
        embodied_gco2=2_600_000.0,       # ~325 kgCO2/chip accel-class estimate
        lifetime_s=4 * 365 * 24 * 3600.0,
        ci_mfg_g_per_kwh=550.0,
        ewif_mfg_l_per_kwh=1.8,
        wsf_mfg=0.40,
        idle_power_w=8 * 60.0,
        peak_power_w=8 * 250.0,          # ~197 TFLOP/s bf16 chip at ~250 W
    )


# ---------------------------------------------------------------------------
# Per-node power model (ichnos-style idle/peak utilization curve)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Linear idle/peak utilization power curve of one server node:

        P(u) = P_idle + (P_peak − P_idle) · u        [W],  u ∈ [0, 1]

    Replaces the flat per-job ``energy_kwh`` estimate at trace-generation
    time: a task's energy is its utilization-dependent draw integrated over
    its execution window. Pure and array-transparent like the Eq (1)-(6)
    functions.
    """
    idle_w: float
    peak_w: float

    @classmethod
    def from_server(cls, server: "ServerSpec") -> "PowerModel":
        return cls(idle_w=server.idle_power_w, peak_w=server.peak_power_w)

    def power_w(self, utilization: Array) -> Array:
        import numpy as np
        u = np.clip(utilization, 0.0, 1.0)
        return self.idle_w + (self.peak_w - self.idle_w) * u

    def energy_kwh(self, utilization: Array, exec_time_s: Array,
                   servers: Array = 1) -> Array:
        """Energy of ``servers`` nodes running ``exec_time_s`` at
        ``utilization``  [kWh]."""
        return self.power_w(utilization) * exec_time_s * servers / 3.6e6


# ---------------------------------------------------------------------------
# Per-region embodied-carbon amortization (the third accounting dimension)
# ---------------------------------------------------------------------------

#: Relative embodied-carbon factor of each region's server fleet. The
#: structure encodes a fleet-age tension: regions that decarbonized their
#: grid early also run the oldest, lifetime-extended fleets (depreciated
#: hardware amortizes little embodied carbon per job), while regions in
#: the middle of a build-out boom run freshly manufactured servers that
#: carry the most *unamortized* embodied carbon. So the cleanest-grid
#: region sits LOW here and the boom region sits high — which is what
#: makes the three-way objective a genuine trade: the embodied-cheap
#: region is operationally cheap on carbon but expensive on water.
#: Applied multiplicatively to the server's amortization rate; regions
#: beyond the table cycle through it. Deterministic and documented so
#: accounting is reproducible — a telemetry-side table can replace it
#: later.
REGION_EMBODIED_SCALE = (0.70, 1.00, 1.30, 1.20, 1.10)


def region_embodied_scale(num_regions: int):
    """[num_regions] per-region embodied amortization factors."""
    import numpy as np
    base = np.asarray(REGION_EMBODIED_SCALE)
    return base[np.arange(num_regions) % len(base)]


def embodied_rate_g_per_s(server: "ServerSpec") -> float:
    """Amortized embodied-carbon rate of one server: gCO2e per server-second
    (ichnos ``EmbodiedCarbon`` style — total embodied CO2 spread uniformly
    over the hardware lifetime)."""
    return server.embodied_gco2 / server.lifetime_s


def job_embodied(exec_time_s: Array, server: "ServerSpec",
                 region_scale: Array = 1.0, servers: Array = 1) -> Array:
    """Embodied gCO2e a job's execution amortizes: rate · t_j · servers,
    scaled by the per-region fleet factor. This is the NEW accounting
    column — it is *not* folded into the Eq (1) carbon the pricers already
    report (that keeps the original embodied term for backward parity)."""
    return embodied_rate_g_per_s(server) * exec_time_s * servers * region_scale


# ---------------------------------------------------------------------------
# Convenience: footprints of a (job, region, time) triple
# ---------------------------------------------------------------------------

def job_carbon(energy_kwh: Array, exec_time_s: Array, ci: Array,
               server: ServerSpec) -> Array:
    return total_carbon(energy_kwh, ci, exec_time_s, server.lifetime_s,
                        server.embodied_gco2)


def job_water(energy_kwh: Array, exec_time_s: Array, pue: Array, ewif: Array,
              wue: Array, wsf_dc: Array, server: ServerSpec) -> Array:
    return total_water(energy_kwh, pue, ewif, wue, wsf_dc, exec_time_s,
                       server.lifetime_s, server.embodied_water_l)
