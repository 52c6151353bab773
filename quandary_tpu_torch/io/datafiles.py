"""Readers/writers for the reference's .dat state/vector formats.

Format (quandary.py:551-641): one value per line; complex objects are stored
column-major vectorized, all real parts first, then all imaginary parts.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def write_vector(path: str, values) -> None:
    with open(path, "w", newline="\n") as f:
        for v in np.asarray(values).reshape(-1):
            f.write("{:20.13e}\n".format(float(v)))


def read_vector(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1)


def write_complex_state(path: str, state: np.ndarray) -> None:
    """Vector or matrix -> [Re (col-major); Im (col-major)]."""
    state = np.asarray(state)
    vec = np.concatenate([np.real(state).ravel(order="F"),
                          np.imag(state).ravel(order="F")])
    write_vector(path, vec)


def read_complex_state(path: str, dim: int, is_matrix: bool) -> np.ndarray:
    """Inverse of write_complex_state; dim is the matrix/vector dimension."""
    vals = read_vector(path)
    n = dim * dim if is_matrix else dim
    re = vals[:n]
    im = vals[n: 2 * n]
    if is_matrix:
        return (re.reshape(dim, dim, order="F")
                + 1j * im.reshape(dim, dim, order="F"))
    return re + 1j * im


def write_hamiltonian_sys(path: str, Hsys: np.ndarray) -> None:
    """hamiltonian_Hsys.dat: sparse triplets 'row col re im'
    (quandary.py:599-606)."""
    H = np.asarray(Hsys)
    with open(path, "w", newline="\n") as f:
        f.write("# row col Hsys_real Hsys_imag \n")
        nz = np.nonzero(H)
        for i, j in zip(*nz):
            v = complex(H[i, j])
            f.write(f"{i} {j} {v.real:.13e} {v.imag:.13e}\n")


def write_hamiltonian_ctrl(path: str, Hc_re, Hc_im) -> None:
    """hamiltonian_Hc.dat: 'osc row col re im' (quandary.py:608-617)."""
    with open(path, "w", newline="\n") as f:
        f.write("# oscillator row col Hc_real Hc_imag \n")
        for iosc in range(max(len(Hc_re), len(Hc_im))):
            re = np.asarray(Hc_re[iosc]) if iosc < len(Hc_re) else 0.0
            im = np.asarray(Hc_im[iosc]) if iosc < len(Hc_im) else 0.0
            Hc = np.asarray(re) + 1j * np.asarray(im)
            nz = np.nonzero(Hc)
            for i, j in zip(*nz):
                v = complex(Hc[i, j])
                f.write(f"{iosc} {i} {j} {v.real:.13e} {v.imag:.13e}\n")


def read_hamiltonian_sys(path: str, dim: int) -> np.ndarray:
    """hamiltonian_Hsys.dat: lines 'row col re im' (quandary.py:599-606),
    '#' comments allowed. Parses with the native C++ triplet reader when
    available (the reference reads these files natively on rank 0,
    hamiltonianfilereader.cpp:21-105); pure-Python fallback otherwise."""
    from .native import read_triplets
    trip = read_triplets(path, 2)
    H = np.zeros((dim, dim), dtype=np.complex128)
    if trip is not None:
        ids, vals = trip
        H[ids[:, 0], ids[:, 1]] = vals
        return H
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            i, j = int(parts[0]), int(parts[1])
            H[i, j] = float(parts[2]) + 1j * float(parts[3])
    return H


def read_hamiltonian_ctrl(path: str, dim: int, noscillators: int):
    """hamiltonian_Hc.dat: lines 'osc row col re im' (quandary.py:608-617).
    Returns (Hc_re list, Hc_im list). Native triplet parse when available."""
    from .native import read_triplets
    Hc = [np.zeros((dim, dim), dtype=np.complex128) for _ in range(noscillators)]
    trip = read_triplets(path, 3)
    if trip is not None:
        ids, vals = trip
        for k in range(noscillators):
            sel = ids[:, 0] == k
            Hc[k][ids[sel, 1], ids[sel, 2]] = vals[sel]
    else:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                k = int(parts[0])
                i, j = int(parts[1]), int(parts[2])
                Hc[k][i, j] = float(parts[3]) + 1j * float(parts[4])
    return [np.real(H) for H in Hc], [np.imag(H) for H in Hc]
