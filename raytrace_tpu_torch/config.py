"""Run configuration (port of raytrace_tpu/config.py, the subset the port
runs).

`MediumConfig` and `RunConfig` keep every field of the JAX package's
dataclasses, so a RunConfig JSON written by either package loads in the
other; a field that selects a feature the port has not ported yet raises
NotImplementedError when the run is built (models/medium.py, run.py).
`preset()` serves every preset of the JAX package: the 2D
latitude-frame CA1992 configs ensemble10k, ensemble10k_production,
ensemble10k_local (the local arc ceiling), lat_fan, knee and mr_fan, the
He+-band EMIC fan emic_heband (multi-ion, the '-' root), the colatitude
frame's single ray raymain, the 3D dipole-frame configs 3d, knee_3d,
ensemble3d and ensemble10k_3d, the 3D configs over the MLT-resolved
medium, ensemble10k_plume and mr_fan_3d, and the plume fan over the
non-axial fields, ensemble10k_tilted and ensemble10k_igrf.
"""

import dataclasses
import json

import numpy as np

from .constants import B0_2D, B0_3D, RE
from .integrate.events import StopSpec
from .integrate.solve import SolverConfig
from .models.ionosphere import IRI_DAYSIDE_FIT, TRACED_FIT
from .models.medium import make_env
from .parallel.ensemble import LaunchSpec


@dataclasses.dataclass
class MediumConfig:
    b0: float = B0_3D
    iono_fit: str = "traced"        # "traced" | "iri_dayside"
    plasmasphere: bool = True
    kp_max: float = 3.0
    day: float = 0.0
    rbar: float = 90.0
    mlt: float = 2.0
    de_correction: bool = False
    ps_smooth: float = 0.0
    iono_mlt: bool = False
    ps_model: str = "ca1992"
    gcpm_bpow: float = 1.0
    gcpm_knee: float = 0.2
    b_model: str = "dipole"
    b_tilt: float = 0.0
    b_tilt_phi: float = 0.0
    duct_amp: float = 0.0
    duct_l0: float = 3.0
    duct_w: float = 0.1
    eta_he: float = 0.0
    eta_o: float = 0.0
    ps_refill: float = 0.0
    ps_refill_q: float = 0.0
    ps_refill_lref: float = 4.0
    ps_mlt: bool = False
    ps_mlt_harmonics: int = 3
    ps_mlt_tamp: float = 1800.0

    def build(self):
        fit = TRACED_FIT if self.iono_fit == "traced" else IRI_DAYSIDE_FIT
        return make_env(
            b0=self.b0, iono_fit=fit, plasmasphere_on=self.plasmasphere,
            kp_max=self.kp_max, day=self.day, rbar=self.rbar, mlt=self.mlt,
            de_correction=self.de_correction, ps_smooth=self.ps_smooth,
            iono_mlt=self.iono_mlt, ps_model=self.ps_model,
            gcpm_bpow=self.gcpm_bpow, gcpm_knee=self.gcpm_knee,
            b_model=self.b_model, b_tilt=self.b_tilt,
            b_tilt_phi=self.b_tilt_phi, duct_amp=self.duct_amp,
            duct_l0=self.duct_l0, duct_w=self.duct_w,
            eta_he=self.eta_he, eta_o=self.eta_o,
            ps_refill=self.ps_refill, ps_refill_q=self.ps_refill_q,
            ps_refill_lref=self.ps_refill_lref,
            ps_mlt=self.ps_mlt, ps_mlt_harmonics=self.ps_mlt_harmonics,
            ps_mlt_tamp=self.ps_mlt_tamp,
        )


@dataclasses.dataclass
class RunConfig:
    """One JSON-serializable description of a run (fields and defaults
    as in the JAX package's RunConfig)."""

    name: str = "run"
    frame: str = "2d_lat"
    medium: MediumConfig = dataclasses.field(default_factory=MediumConfig)
    r0: float = (RE + 1.0e6) / RE
    lats: tuple = (np.pi / 4,)
    chis: tuple = (0.0,)
    phis: tuple = (0.0,)
    rays: tuple = ()
    freqs: tuple = (1000.0,)
    rho0: tuple = (1.0, 1.0, 0.0)
    rho_on_shell: bool = False
    rtol: float = 1.0e-7
    atol: float = 1.0e-12
    dt0: float = 1.0e-4
    adaptive: bool = True
    stepper: str = "auto"
    max_steps: int = 20000
    dt_max: float = 1.0e6 / RE
    ds_max: float = 0.0
    ds_local: bool = False
    ds_local_frac: float = 1.0
    ds_local_w: float = 0.1
    base_stepper: str = "dopri5"
    grad_mode: str = "fused"
    wave_mode: str = "whistler"
    t_max: float = 5.0e9 / RE
    r_floor: float = 1.0
    r_ceil: float = float("inf")
    group_time_max: float = float("inf")
    stop_at_equator: bool = False
    stop_evanescent: bool = False
    dtype: str = "float32"
    use_rounds: bool = True
    round_steps: tuple = ()
    continue_until_done: bool = False
    max_continuations: int = 4
    save_every: int = 0
    save_diagnostics: bool = False
    sensitivity_rays: int = 0

    @property
    def root(self):
        return 1.0 if self.wave_mode == "whistler" else -1.0

    def solver(self):
        rtol, atol = self.rtol, self.atol
        if self.dtype == "float32":
            # float32's embedded error estimator bottoms out near 10 eps
            # relative; asking for less manufactures rejection storms
            rtol = max(rtol, 1.2e-6)
            atol = max(atol, 1.0e-9)
        knee, shells = 0.0, ()
        if self.ds_local:
            knee = float(self.medium.build().lppo)
            if self.medium.duct_amp != 0.0:
                shells = ((self.medium.duct_l0, self.medium.duct_w),)
        return SolverConfig(
            rtol=rtol, atol=atol, dt0=self.dt0,
            dt_max=self.dt_max, ds_max=self.ds_max,
            ds_local_knee=knee, ds_local_frac=self.ds_local_frac,
            ds_local_w=self.ds_local_w, ds_local_shells=shells,
        )

    def stop(self):
        lat_sign, lat_offset = (
            (1.0, 0.0) if self.frame == "2d_lat" else (-1.0, np.pi / 2)
        )
        return StopSpec(
            r_floor=self.r_floor, r_ceil=self.r_ceil, t_max=self.t_max,
            group_time_max=self.group_time_max,
            stop_at_equator=1.0 if self.stop_at_equator else 0.0,
            lat_sign=lat_sign, lat_offset=lat_offset,
            stop_retrograde=1.0 if self.stop_evanescent else 0.0,
        )

    def launch(self):
        return LaunchSpec(
            r0=self.r0, lats=tuple(self.lats), chis=tuple(self.chis),
            freqs=tuple(self.freqs),
        )

    def to_json(self, path=None):
        s = json.dumps(dataclasses.asdict(self), indent=2, default=list)
        if path:
            with open(path, "w") as fh:
                fh.write(s)
        return s

    @classmethod
    def from_json(cls, src):
        if isinstance(src, str) and src.lstrip().startswith("{"):
            d = json.loads(src)
        else:
            with open(src) as fh:
                d = json.load(fh)
        med = MediumConfig(**d.pop("medium", {}))
        for key in ("lats", "chis", "phis", "freqs", "rho0", "round_steps"):
            if key in d:
                d[key] = tuple(d[key])
        if "rays" in d:
            d["rays"] = tuple(tuple(r) for r in d["rays"])
        return cls(medium=med, **d)


_PRESETS = {
    # RayMain.jl single ray (RayMain.jl:382-387): the colatitude frame,
    # ionosphere only
    "raymain": lambda: dict(
        name="raymain", frame="2d_colat",
        medium=MediumConfig(b0=B0_2D, plasmasphere=False),
        lats=(np.pi / 4,), chis=(0.0,), freqs=(5000.0,),
    ),
    # RayTrace_lat.jl fan (RayTrace_lat.jl:333-338)
    "lat_fan": lambda: dict(
        name="lat_fan", frame="2d_lat",
        medium=MediumConfig(b0=B0_2D),
        lats=tuple(np.linspace(0.5, 1.0, 16)),
        chis=tuple(np.linspace(-0.3, 0.3, 8)),
        freqs=(1000.0,),
    ),
    # adaptive rays through the plasmapause knee
    "knee": lambda: dict(
        name="knee", frame="2d_lat",
        medium=MediumConfig(b0=B0_2D),
        lats=tuple(np.linspace(0.9, 1.15, 16)),
        chis=tuple(np.linspace(-0.2, 0.2, 8)),
        freqs=(500.0, 1000.0, 2000.0),
    ),
    # the 10k multi-frequency ensemble: auto stepping over the bs3 base
    "ensemble10k": lambda: dict(
        name="ensemble10k", frame="2d_lat",
        medium=MediumConfig(b0=B0_2D),
        lats=tuple(np.linspace(0.45, 1.1, 40)),
        chis=tuple(np.linspace(-0.5, 0.5, 16)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rtol=1.0e-5, atol=1.0e-8, base_stepper="bs3",
    ),
    # the same ensemble at the production ceilings: the arc ceiling at
    # 2e6 m with the phase ceiling relaxed to 8e6 m
    "ensemble10k_production": lambda: dict(
        name="ensemble10k_production", frame="2d_lat",
        medium=MediumConfig(b0=B0_2D),
        lats=tuple(np.linspace(0.45, 1.1, 40)),
        chis=tuple(np.linspace(-0.5, 0.5, 16)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rtol=1.0e-5, atol=1.0e-8, base_stepper="bs3",
        ds_max=2.0e6 / RE, dt_max=8.0e6 / RE,
    ),
    # the production fan on the local arc ceiling: tight only within
    # ds_local_w of the plasmapause shell, opening to r/4.5 over the smooth
    # plasmasphere; the phase ceiling stays the 8e6 m outer bound
    "ensemble10k_local": lambda: dict(
        name="ensemble10k_local", frame="2d_lat",
        medium=MediumConfig(b0=B0_2D),
        lats=tuple(np.linspace(0.45, 1.1, 40)),
        chis=tuple(np.linspace(-0.5, 0.5, 16)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rtol=1.0e-5, atol=1.0e-8, base_stepper="bs3",
        ds_local=True, dt_max=8.0e6 / RE,
    ),
    # He+-band EMIC rays (the '-' root) in a multi-ion plasma: equatorial
    # launches just below the local He+ gyrofrequency
    "emic_heband": lambda: dict(
        name="emic_heband", frame="2d_lat", wave_mode="emic",
        medium=MediumConfig(b0=B0_2D, eta_he=0.1, eta_o=0.02),
        r0=2.0,
        lats=tuple(np.linspace(-0.1, 0.1, 8)),
        chis=(0.0, 0.2),
        freqs=(1.0, 1.4, 1.8),
        t_max=200.0, max_steps=8000,
    ),
    # RayTrace_3D.jl single ray (RayTrace_3D.jl:390-395), off-shell rho0
    "3d": lambda: dict(
        name="3d", frame="3d",
        medium=MediumConfig(b0=B0_3D),
        lats=(np.pi / 4,), freqs=(1000.0,), rho0=(1.0, 1.0, 0.0),
    ),
    # 3D rays launched to traverse the plasmapause knee
    "knee_3d": lambda: dict(
        name="knee_3d", frame="3d",
        medium=MediumConfig(b0=B0_3D),
        lats=tuple(np.linspace(0.9, 1.15, 12)),
        freqs=(500.0, 1000.0, 2000.0),
        rho0=(1.0, 1.0, 0.0),
        rtol=1.0e-5, atol=1.0e-8,
    ),
    # 1,024 seven-state rays on the dispersion surface at the production
    # arc ceiling
    "ensemble3d": lambda: dict(
        name="ensemble3d", frame="3d",
        medium=MediumConfig(b0=B0_3D),
        lats=tuple(np.linspace(0.45, 1.1, 64)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rho0=(1.0, 1.0, 0.0), rho_on_shell=True,
        rtol=1.0e-5, atol=1.0e-8,
        ds_max=2.0e6 / RE, dt_max=8.0e6 / RE,
    ),
    # the 3D headline: 40 lat x 16 chi x 16 f = 10,240 seven-state rays on
    # the dispersion surface (chi rotates rho0 in the meridional plane) at
    # the production arc ceiling, with short early rounds
    "ensemble10k_3d": lambda: dict(
        name="ensemble10k_3d", frame="3d",
        medium=MediumConfig(b0=B0_3D),
        lats=tuple(np.linspace(0.45, 1.1, 40)),
        chis=tuple(np.linspace(-0.5, 0.5, 16)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rho0=(1.0, 1.0, 0.0), rho_on_shell=True,
        rtol=1.0e-5, atol=1.0e-8, base_stepper="bs3",
        ds_max=2.0e6 / RE, dt_max=8.0e6 / RE,
        round_steps=(512, 1024, 2048),
    ),
    # the 3D headline through the MLT-resolved plasmasphere: 10 lat x 8
    # phi x 8 chi x 16 f = 10,240 seven-state rays spread over all local
    # times, so they sample the dusk plume; solver settings of
    # ensemble10k_3d
    "ensemble10k_plume": lambda: dict(
        name="ensemble10k_plume", frame="3d",
        medium=MediumConfig(b0=B0_3D, ps_mlt=True),
        lats=tuple(np.linspace(0.45, 1.1, 10)),
        phis=tuple(np.linspace(-np.pi, np.pi, 8, endpoint=False)),
        chis=tuple(np.linspace(-0.5, 0.5, 8)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rho0=(1.0, 1.0, 0.0), rho_on_shell=True,
        rtol=1.0e-5, atol=1.0e-8, base_stepper="bs3",
        ds_max=2.0e6 / RE, dt_max=8.0e6 / RE,
        round_steps=(512, 1024, 2048),
    ),
    # the plume fan on a tilted dipole (the realistic ~11.5 deg moment
    # tilt): the MLT axis rides the magnetic longitude and the gradients
    # the general chain (ops/fused.py::mu_and_grads_3d_general); fan and
    # solver settings of ensemble10k_plume
    "ensemble10k_tilted": lambda: dict(
        name="ensemble10k_tilted", frame="3d",
        medium=MediumConfig(b0=B0_3D, ps_mlt=True, b_model="tilted",
                            b_tilt=0.2, b_tilt_phi=0.5),
        lats=tuple(np.linspace(0.45, 1.1, 10)),
        phis=tuple(np.linspace(-np.pi, np.pi, 8, endpoint=False)),
        chis=tuple(np.linspace(-0.5, 0.5, 8)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rho0=(1.0, 1.0, 0.0), rho_on_shell=True,
        rtol=1.0e-5, atol=1.0e-8, base_stepper="bs3",
        ds_max=2.0e6 / RE, dt_max=8.0e6 / RE,
        round_steps=(512, 1024, 2048),
    ),
    # the same fan on the degree-3 IGRF truncation
    "ensemble10k_igrf": lambda: dict(
        name="ensemble10k_igrf", frame="3d",
        medium=MediumConfig(b0=B0_3D, ps_mlt=True, b_model="igrf"),
        lats=tuple(np.linspace(0.45, 1.1, 10)),
        phis=tuple(np.linspace(-np.pi, np.pi, 8, endpoint=False)),
        chis=tuple(np.linspace(-0.5, 0.5, 8)),
        freqs=tuple(np.geomspace(500.0, 8000.0, 16)),
        rho0=(1.0, 1.0, 0.0), rho_on_shell=True,
        rtol=1.0e-5, atol=1.0e-8, base_stepper="bs3",
        ds_max=2.0e6 / RE, dt_max=8.0e6 / RE,
        round_steps=(512, 1024, 2048),
    ),
    # magnetospherically reflecting 2D fan: long multi-bounce rays
    "mr_fan": lambda: dict(
        name="mr_fan", frame="2d_lat",
        medium=MediumConfig(),
        r0=2.5,
        lats=tuple(np.linspace(0.0, 0.5, 16)),
        chis=tuple(np.linspace(-0.9, -0.3, 8)),
        freqs=tuple(np.geomspace(600.0, 1200.0, 16)),
        group_time_max=10.0, t_max=6.0e10 / RE, max_steps=40960,
        ds_max=2.0e6 / RE, dt_max=8.0e6 / RE, base_stepper="bs3",
    ),
    # magnetospheric reflection in the 3D frame over the MLT-resolved
    # medium: 8 lat x 8 phi x 4 chi x 8 f = 2,048 low-altitude rays that
    # mirror at the f = f_LHR surface, drift in longitude through the dusk
    # plume and live for many bounces (the extreme-straggler workload)
    "mr_fan_3d": lambda: dict(
        name="mr_fan_3d", frame="3d",
        medium=MediumConfig(b0=B0_3D, ps_mlt=True),
        lats=tuple(np.linspace(0.95, 1.2, 8)),
        phis=tuple(np.linspace(-np.pi, np.pi, 8, endpoint=False)),
        chis=tuple(np.linspace(-0.3, 0.1, 4)),
        freqs=tuple(np.geomspace(700.0, 1600.0, 8)),
        rho0=(1.0, 0.0, 0.0), rho_on_shell=True,
        rtol=1.0e-6, atol=1.0e-10, base_stepper="bs3",
        dt_max=1.0e6 / RE,
        group_time_max=10.0, t_max=6.0e10 / RE, max_steps=40960,
    ),
}

# presets of the JAX package that need features the port has not yet
# ported ({name: ROADMAP item}): none left
_LATER = {}


def preset(name, **overrides):
    """Named configs the port runs (sorted(_PRESETS))."""
    if name in _LATER:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet (ROADMAP {_LATER[name]}); "
            f"the port has {sorted(_PRESETS)}"
        )
    if name not in _PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(_PRESETS)}"
        )
    d = _PRESETS[name]()
    d.update(overrides)
    return RunConfig(**d)
