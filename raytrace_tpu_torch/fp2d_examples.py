"""The 2D Fokker-Planck chain of examples/chorus_acceleration.py and
examples/belt_competition.py, over either package's side of it.

`CHORUS` is the examples' configuration. `fp2d_grid`, `fp2d_tensors` and
`fp2d_chain` take `k`, a namespace of one package's functions taking and
returning numpy (`fp2d_for` builds the port's; the tests build the JAX
package's beside it), so that both packages run the same recipe:
chip_smoke.py's phase 30 on the card, tests/test_torch_fokker_planck_2d.py
on the CPU, and `kernel_ab --cn-pcg` in turns. The port's modules are
imported inside `fp2d_for`, by absolute name, so that the recipe also
runs over another checkout's package.
"""

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

# The examples' chain: L = 4.5, lower-band chorus of 100 pT, H-band EMIC
# of 1 nT, a 48 x 56 (alpha_eq, p) grid from 30 keV to 6 MeV, 1,440 CN
# steps of 120 s, 8 snapshots, in float64
CHORUS = dict(l_shell=4.5, bw_chorus_pt=100.0, bw_emic_nt=1.0, dt=120.0,
              n_steps=1440, n_snaps=8, n_a=48, n_p=56, e_min=30.0,
              e_max=6000.0, e_fold=150.0, lat_cut=15.0, lat_cut_emic=20.0,
              ba=dict(n_lat=32, n_grid=256, n_bisect=26,
                      momentum_units="mc"))


def fp2d_grid(k, conf=CHORUS):
    """The examples' grid, seed and wave spectra over `k` (a package's
    side of the chain: its fokker_planck_2d, WaveSpectrum and the
    electron gyrofrequency k.fce at the equator of L): (grid, e_c keV,
    f0, chorus, emic)."""
    rl = 1.0 / conf["l_shell"]
    a_lc = math.asin(math.sqrt(rl**3 / math.sqrt(4.0 - 3.0 * rl)))
    grid = k.make_grid_2d(a_lc, conf["n_a"], k.p_from_energy(conf["e_min"]),
                          k.p_from_energy(conf["e_max"]), conf["n_p"])
    e_c = k.energy_from_p(grid.p_c)
    f0 = np.exp(-e_c[None, :] / conf["e_fold"]) * np.ones((conf["n_a"], 1))
    fce = k.fce
    fcp = fce / 1836.15267
    chorus = k.WaveSpectrum(bw_t=conf["bw_chorus_pt"] * 1e-12, f_m=0.30 * fce,
                            df=0.10 * fce, f_lc=0.10 * fce, f_uc=0.45 * fce)
    emic = k.WaveSpectrum(bw_t=conf["bw_emic_nt"] * 1e-9, f_m=0.6 * fcp,
                          df=0.25 * fcp, f_lc=0.3 * fcp, f_uc=0.95 * fcp)
    return grid, e_c, f0, chorus, emic


def fp2d_tensors(k, grid, e_c, chorus, emic, conf=CHORUS):
    """The bounce-averaged tensors (daa, dap, dpp) on the grid over `k`
    (k.bounce_averaged on k.env), 'mc' units, float64 numpy: chorus
    (whistler mode, |lam| <= 15 deg) and EMIC (n = -1, |lam| <= 20
    deg)."""
    def one(spec, mode, cut):
        ba = k.bounce_averaged(e_c[None, :], grid.alpha_c[:, None],
                               conf["l_shell"], k.env, spec,
                               lat_cut_deg=cut, mode=mode, **conf["ba"])
        return tuple(np.asarray(ba[q], np.float64)
                     for q in ("daa", "dap", "dpp"))

    return (one(chorus, "whistler", conf["lat_cut"]),
            one(emic, "emic", conf["lat_cut_emic"]))


def fp2d_for(dev, dtype, conf=CHORUS):
    """The port's side of the 2D chain on `dev`, numpy in and out: the
    operator and the evolution in `dtype` (the tensors are computed in
    float64 and cast), evolve_cn_2d through the kernel on the card and
    the plain version on the CPU."""
    from raytrace_tpu_torch import diffusion, fokker_planck_2d as fp2
    from raytrace_tpu_torch.constants import FCE_E
    from raytrace_tpu_torch.models import medium
    from raytrace_tpu_torch.models.medium import make_env_lat

    env = make_env_lat()
    one = torch.ones((), dtype=torch.float64)
    fce = FCE_E * float(medium.b_mag(conf["l_shell"] * one, 0.0 * one, env))

    def bounce_averaged(*a, **kw):
        ba = diffusion.bounce_averaged(*a, device=dev, **kw)
        return {q: v.cpu().numpy() for q, v in ba.items()
                if isinstance(v, torch.Tensor)}

    def make_operator_2d(grid, *ten):
        return fp2.make_operator_2d(
            grid, *(torch.tensor(t, device=dev).to(dtype) for t in ten))

    def evolve(f0, op, dt, n, every):
        x = torch.as_tensor(f0, device=dev).to(dtype)
        f_end, snaps = fp2.evolve_cn_2d(x, op, dt, n, save_every=every)
        return f_end.cpu().numpy(), snaps.cpu().numpy()

    return SimpleNamespace(
        env=env, fce=fce, dtype=dtype, WaveSpectrum=diffusion.WaveSpectrum,
        bounce_averaged=bounce_averaged, make_grid_2d=fp2.make_grid_2d,
        p_from_energy=fp2.p_from_energy, energy_from_p=fp2.energy_from_p,
        make_operator_2d=make_operator_2d, evolve_cn_2d=evolve,
        content_2d=lambda op, f: float(fp2.content_2d(op, f)),
        mass=lambda op: op.mass.cpu().numpy().astype(np.float64))


def fp2d_chain(k, grid, e_c, f0, t_ch, t_em, conf=CHORUS):
    """examples/chorus_acceleration.py's evolution and
    examples/belt_competition.py's two (chorus only, chorus + EMIC) over
    `k`, whose make_operator_2d, evolve_cn_2d and content_2d take and
    return numpy (`k.dtype` the evolution's). Returns the numbers the
    examples print and plot: the snapshots' alpha_eq = 80 deg rows, the
    1 and 3 MeV PSD gains there, content_2d at the end, the last
    snapshots' 3 MeV pitch-angle profiles and the trapped > 1 MeV content
    of every snapshot, and each evolution's wall (`walls`, host clock
    around a call that returns numpy)."""
    n_steps, every = conf["n_steps"], conf["n_steps"] // conf["n_snaps"]
    i80 = int(np.argmin(np.abs(grid.alpha_c - math.radians(80.0))))
    j1, j3 = (int(np.argmin(np.abs(e_c - e))) for e in (1000.0, 3000.0))
    sel = e_c >= 1000.0
    out, walls = {}, {}
    t_sum = tuple(a + b for a, b in zip(t_ch, t_em))
    for name, ten in (("chorus", t_ch), ("sum", t_sum)):
        op = k.make_operator_2d(grid, *ten)
        t0 = time.perf_counter()
        f_end, snaps = k.evolve_cn_2d(f0, op, conf["dt"], n_steps, every)
        walls[name] = time.perf_counter() - t0
        mass = k.mass(op)
        out[name] = dict(
            rows80=snaps[:, i80], f_end=f_end, snaps=snaps,
            gain=[float(snaps[-1, i80, j] / f0[i80, j]) for j in (j1, j3)],
            content=float(k.content_2d(op, f_end)),
            prof3=snaps[-1, :, j3],
            trapped=np.array([(s * mass)[:, sel].sum() for s in snaps]))
    out["walls"] = walls
    return out
