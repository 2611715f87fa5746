"""Radial (L-shell) diffusion with wave-driven losses (port of
raytrace_tpu/radial.py).

    df/dt = L^2 d/dL [ D_LL L^-2 df/dL ] - f / tau(L) + (sources),

the 1D Fokker-Planck machinery of fokker_planck.py with alpha -> L and
G = L^-2: conservative FV face fluxes, Crank-Nicolson (`evolve_radial`,
on the card one step a CUDA graph) and a direct Thomas solve for steady
states; the inner and outer walls absorbing, the outer Dirichlet value
f_out held through the right-hand side. D_LL is a user-supplied profile
(`dll_power_law`); tau(L) comes from the framework's own pitch-angle
chain (diffusion.bounce_averaged -> fokker_planck.precipitation_lifetime).
Device and dtype as in placement.py.
"""

import numpy as np
import torch

from .fokker_planck import build_operator, evolve_cn, thomas_solve
from .placement import device_of, place


def make_l_grid(l_in=1.1, l_out=7.0, n_cells=160, device=None):
    """Uniform cell-centred grid on [l_in, l_out] (numpy's linspace, moved
    to the device). Returns (centers, faces, dl), dl a Python float."""
    dev = device_of(device=device)
    faces = np.linspace(float(l_in), float(l_out), n_cells + 1)
    centers = 0.5 * (faces[:-1] + faces[1:])
    return (torch.as_tensor(centers, device=dev),
            torch.as_tensor(faces, device=dev), float(faces[1] - faces[0]))


def dll_power_law(l, d0=1.0e-8, l0=4.0, q=10.0, device=None):
    """D_LL = d0 (L/l0)^q [1/s]: the standard ULF scaling class (d0 the
    rate at L = l0; q ~ 6-10). Magnitude and exponent are inputs."""
    (l,) = place(l, device=device)
    return d0 * torch.exp(q * torch.log(l / l0))


def build_radial_operator(l_centers, l_faces, dl, dll_faces,
                          inv_tau_centers=None, device=None):
    """Tridiagonal A with (A f) = L^2 d/dL [D_LL L^-2 df/dL] - f/tau.

    dll_faces: D_LL at the n+1 faces; inv_tau_centers: the loss rate
    1/tau(L) at the centres (None: no loss). Both walls absorbing; the
    sources enter through the right-hand side (steady_state,
    evolve_radial)."""
    l_centers, l_faces, dll_faces = place(l_centers, l_faces, dll_faces,
                                           device=device)
    g_c = 1.0 / (l_centers ** 2)
    g_f = 1.0 / (l_faces ** 2)
    lo, dg, up = build_operator(dll_faces, g_c, g_f, dl,
                                left_bc="absorbing", right_bc="absorbing")
    if inv_tau_centers is not None:
        dg = dg - place(inv_tau_centers, device=dg.device)[0]
    return lo, dg, up


def _outer_source(l_centers, l_faces, dl, dll_faces, f_out):
    """The right-hand side holding the outer Dirichlet value f_out: the
    absorbing wall's flux 2 G_N D_N (0 - f_N)/dl with f_wall = f_out adds
    2 G_N D_N f_out / (dl^2 G_n) to the last cell's tendency."""
    b = torch.zeros_like(l_centers)
    g_wall = 1.0 / float(l_faces[-1]) ** 2
    g_n = 1.0 / float(l_centers[-1]) ** 2
    b[-1] = 2.0 * float(dll_faces[-1]) * g_wall * f_out / (dl * dl * g_n)
    return b


def _system(l_centers, l_faces, dl, dll_faces, f_out, inv_tau_centers,
            source_centers, device):
    """(A's (lower, diag, upper), the constant right-hand side b)."""
    l_centers, l_faces, dll_faces = place(l_centers, l_faces, dll_faces,
                                           device=device)
    tri = build_radial_operator(l_centers, l_faces, dl, dll_faces,
                                inv_tau_centers)
    b = _outer_source(l_centers, l_faces, dl, dll_faces, f_out)
    if source_centers is not None:
        b = b + place(source_centers, device=b.device)[0]
    return tri, b


def steady_state(l_centers, l_faces, dl, dll_faces, f_out=1.0,
                 inv_tau_centers=None, source_centers=None, device=None):
    """Equilibrium profile: -A f = b_outer + S by one Thomas sweep.
    source_centers: a volumetric injection rate S(L) [f-units/s] at the
    centres (e.g. the CRAND source of the inner belt)."""
    (lo, dg, up), b = _system(l_centers, l_faces, dl, dll_faces, f_out,
                              inv_tau_centers, source_centers, device)
    return thomas_solve(-lo, -dg, -up, b)


def evolve_radial(f0, l_centers, l_faces, dl, dll_faces, dt, n_steps,
                  f_out=1.0, inv_tau_centers=None, source_centers=None,
                  save_every=0, device=None, graph=True):
    """Crank-Nicolson evolution with the outer Dirichlet source held:
    (I - dt/2 A) f+ = (I + dt/2 A) f + dt b per step, through
    fokker_planck.evolve_cn (save_every, the remainder and graph as
    there)."""
    dev = device_of(f0, l_centers, l_faces, dll_faces, device=device)
    tri, b = _system(l_centers, l_faces, dl, dll_faces, f_out,
                     inv_tau_centers, source_centers, dev)
    return evolve_cn(place(f0, device=dev)[0], tri, dt, n_steps,
                     save_every=save_every, source=b, graph=graph)
