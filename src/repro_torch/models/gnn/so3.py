"""SO(3) algebra for MACE: real spherical harmonics (l <= 4) and real
Clebsch-Gordan coupling tensors.

Complex CG coefficients come from the standard Racah closed form; the
real-basis coupling tensors are obtained by conjugating with the
complex->real unitary.  For every allowed (l1, l2, l3) the resulting
tensor is purely real or purely imaginary — we keep the realized
(phase-fixed) tensor.  Everything is precomputed in numpy at trace
time; only the contractions themselves run on device.

The numpy code (the CG tensors, the unitary, the bookkeeping) is the JAX
package's, copied line for line, so both packages build the same
tensors bit for bit; ``spherical_harmonics`` is a torch function.

Conventions: real SH index order m = (-l, ..., 0, ..., +l); harmonics
are L2-normalized on the sphere up to a common constant (Racah
normalization Y_00 = 1), which MACE's learnable weights absorb.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch


# ----------------------------------------------------------------------
# Complex Clebsch-Gordan (Racah formula)
# ----------------------------------------------------------------------

def _f(n: int) -> float:
    return float(math.factorial(n))


def cg_complex(j1: int, m1: int, j2: int, m2: int, j3: int, m3: int) -> float:
    """<j1 m1 j2 m2 | j3 m3> (Condon-Shortley)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    pref = math.sqrt(
        (2 * j3 + 1) * _f(j3 + j1 - j2) * _f(j3 - j1 + j2) * _f(j1 + j2 - j3)
        / _f(j1 + j2 + j3 + 1))
    pref *= math.sqrt(_f(j3 + m3) * _f(j3 - m3) * _f(j1 - m1) * _f(j1 + m1)
                      * _f(j2 - m2) * _f(j2 + m2))
    total = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        denoms = [k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
                  j3 - j2 + m1 + k, j3 - j1 - m2 + k]
        if any(d < 0 for d in denoms):
            continue
        total += (-1.0) ** k / np.prod([_f(d) for d in denoms])
    return pref * total


# ----------------------------------------------------------------------
# Complex -> real unitary for spherical harmonics.
# Real index mu in (-l..l): mu<0 -> sin-type, mu>0 -> cos-type.
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def real_unitary(l: int) -> np.ndarray:
    """U with Y^real_mu = sum_m U[mu+l, m+l] Y^complex_m."""
    dim = 2 * l + 1
    u = np.zeros((dim, dim), dtype=np.complex128)
    s2 = 1.0 / math.sqrt(2.0)
    for mu in range(-l, l + 1):
        if mu > 0:
            u[mu + l, mu + l] = (-1) ** mu * s2
            u[mu + l, -mu + l] = s2
        elif mu == 0:
            u[l, l] = 1.0
        else:  # mu < 0:  Y^real_mu = (i/sqrt2)(Y^{mu} - (-1)^mu Y^{-mu})
            u[mu + l, mu + l] = 1j * s2
            u[mu + l, -mu + l] = -1j * s2 * (-1) ** mu
    return u


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor, shape (2l1+1, 2l2+1, 2l3+1)."""
    c = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), dtype=np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            c[m1 + l1, m2 + l2, m3 + l3] = cg_complex(l1, m1, l2, m2, l3, m3)
    u1, u2, u3 = real_unitary(l1), real_unitary(l2), real_unitary(l3)
    cr = np.einsum("am,bn,ck,mnk->abc", u1, u2, np.conj(u3), c)
    re, im = np.real(cr), np.imag(cr)
    if np.abs(im).max() > np.abs(re).max() * 1e-8 + 1e-12:
        if np.abs(re).max() >= np.abs(im).max() * 1e-8 + 1e-12:
            raise ValueError(
                f"coupling tensor ({l1},{l2},{l3}) is neither pure-real "
                f"nor pure-imaginary: |re|={np.abs(re).max():.3e} "
                f"|im|={np.abs(im).max():.3e}")
        return np.ascontiguousarray(im)
    return np.ascontiguousarray(re)


# ----------------------------------------------------------------------
# Real spherical harmonics (hard-coded cartesian forms up to l=4 not
# needed — MACE uses l<=3; we provide l<=2 + l=3 for headroom).
# Racah-normalized: Y_0 = 1, |Y_l|^2 summed over m = 2l+1 ... absorbed
# into learnable radial weights, so only *consistency* with real_cg's
# basis matters: both use the same complex->real unitary.
# ----------------------------------------------------------------------

def sh_l1(xyz):
    # complex Y_1^m in Condon-Shortley, transformed by real_unitary(1):
    # order (mu=-1, 0, +1) == (y, z, x) up to a common constant.
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return [y, z, x]


def sh_l2(xyz):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    s3 = math.sqrt(3.0)
    return [
        s3 * x * y,                       # mu=-2
        s3 * y * z,                       # mu=-1
        0.5 * (3 * z * z - 1.0),          # mu=0   (|r|=1 assumed)
        s3 * x * z,                       # mu=+1
        0.5 * s3 * (x * x - y * y),       # mu=+2
    ]


def spherical_harmonics(l_max: int, vectors: torch.Tensor) -> torch.Tensor:
    """Concatenated real SH of the directions of ``vectors`` (..., 3) ->
    (..., (l_max+1)^2), in the vectors' dtype and device; a zero vector
    gives the harmonics of (0, 0, 0) (the model masks such edges)."""
    norm = torch.clamp(torch.linalg.norm(vectors, dim=-1, keepdim=True),
                       min=1e-9)
    u = vectors / norm
    outs = [torch.ones(u.shape[:-1], dtype=u.dtype, device=u.device)]
    if l_max >= 1:
        outs += sh_l1(u)
    if l_max >= 2:
        outs += sh_l2(u)
    if l_max >= 3:
        raise NotImplementedError("l_max <= 2 supported (config uses 2)")
    return torch.stack(outs, dim=-1)


# ----------------------------------------------------------------------
# Irrep bookkeeping for concatenated (l, m) axes.
# ----------------------------------------------------------------------

def irrep_slices(l_max: int) -> List[slice]:
    out, off = [], 0
    for l in range(l_max + 1):
        out.append(slice(off, off + 2 * l + 1))
        off += 2 * l + 1
    return out


def num_sh(l_max: int) -> int:
    return (l_max + 1) ** 2


@lru_cache(maxsize=None)
def coupling_table(l_max: int) -> List[Tuple[int, int, int, np.ndarray]]:
    """All allowed (l1, l2, l3 <= l_max) couplings with their real CG."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3, real_cg(l1, l2, l3)))
    return out


@lru_cache(maxsize=None)
def dense_coupling(l_max: int) -> np.ndarray:
    """Dense coupling tensor W (S, S, S) with S=(l_max+1)^2 combining all
    allowed (l1,l2->l3) paths (each path weight 1; learnable per-path
    weights are applied by the model before contraction)."""
    s = num_sh(l_max)
    w = np.zeros((s, s, s), dtype=np.float64)
    sl = irrep_slices(l_max)
    for l1, l2, l3, cg in coupling_table(l_max):
        w[sl[l1], sl[l2], sl[l3]] += cg
    return w


def wigner_d_from_rotation(l: int, rot: np.ndarray, n_samples: int = 200,
                           seed: int = 0) -> np.ndarray:
    """Real Wigner D for rotation matrix ``rot``: solves the linear
    system Y(R r) = D Y(r) over sampled unit vectors (float64).  Test
    utility."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_samples, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    sl = irrep_slices(l)[l]
    y = spherical_harmonics(l, torch.from_numpy(v)).numpy()[:, sl]
    y_rot = spherical_harmonics(l, torch.from_numpy(v @ rot.T)).numpy()[:, sl]
    d, *_ = np.linalg.lstsq(y, y_rot, rcond=None)
    return d.T
