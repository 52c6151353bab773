"""Ladder operators and the standard superconducting-qubit Hamiltonian model.

Builds the time-independent system Hamiltonian and the per-oscillator control
operators for Q coupled Duffing oscillators in the rotating frame. All inputs
are in GHz (cycles/ns) as in the reference Python front end; outputs are in
rad/ns (multiplied by 2*pi). Semantics mirror quandary.py:1114-1199
(`hamiltonians`) and the appendix of the reference user guide
(docs/mkdocs/user_guide.md:500-531).

These builders run on the host in numpy; the resulting dense operator stacks
are transferred to device once and reused across time steps.
"""

from __future__ import annotations

import numpy as np


def lowering(n: int) -> np.ndarray:
    """Lowering operator a of dimension n (quandary.py:1063-1064)."""
    return np.diag(np.sqrt(np.arange(1, n)), k=1)


def number(n: int) -> np.ndarray:
    """Number operator a^dag a of dimension n (quandary.py:1066-1068)."""
    return np.diag(np.arange(n, dtype=float))


def embed(op: np.ndarray, k: int, dims) -> np.ndarray:
    """Embed a single-oscillator operator into the composite Hilbert space:
    I_{pre} (x) op (x) I_{post}, oscillator 0 = slowest axis."""
    pre = int(np.prod(dims[:k], dtype=np.int64)) if k > 0 else 1
    post = int(np.prod(dims[k + 1:], dtype=np.int64)) if k + 1 < len(dims) else 1
    return np.kron(np.kron(np.eye(pre), op), np.eye(post))


def lowering_ops(dims) -> list:
    """Full-dimension lowering operators for each oscillator."""
    return [embed(lowering(dims[k]), k, dims) for k in range(len(dims))]


def coupling_pairs(nqubits: int) -> list:
    """Ordered (k, l) pairs, k < l, matching the flat Jkl/crosskerr list
    layout [J01, J02, ..., J12, J13, ...] (quandary.py:29-30)."""
    return [(k, l) for k in range(nqubits) for l in range(k + 1, nqubits)]


def hamiltonians(*, N, freq01, selfkerr, crosskerr=(), Jkl=(), rotfreq=(),
                 verbose: bool = False):
    """Standard-model system and control Hamiltonians (quandary.py:1114-1199).

    Returns
    -------
    Hsys : (n, n) float array, rad/ns. Duffing + crosskerr + Jkl terms. Note:
        the Jkl dipole coupling is included as TIME-INDEPENDENT here; this
        matrix is used only for time-step estimation and carrier-frequency
        resonance analysis (as in the reference), not for propagation when
        rotation frequencies differ.
    Hc_re : list of (n, n) arrays, a_k + a_k^dag (unitless).
    Hc_im : list of (n, n) arrays, a_k - a_k^dag (unitless).
    """
    N = list(N)
    nqubits = len(N)
    if len(rotfreq) == 0:
        rotfreq = np.zeros(nqubits)
    assert len(selfkerr) == nqubits and len(freq01) == nqubits

    n = int(np.prod(N, dtype=np.int64))
    Amat = lowering_ops(N)

    Hsys = np.zeros((n, n))
    for q in range(nqubits):
        domega = 2.0 * np.pi * (freq01[q] - rotfreq[q])
        xi = 2.0 * np.pi * selfkerr[q]
        ad_a = Amat[q].T @ Amat[q]
        Hsys += domega * ad_a
        Hsys -= xi / 2.0 * (Amat[q].T @ Amat[q].T @ Amat[q] @ Amat[q])

    pairs = coupling_pairs(nqubits)
    if len(crosskerr) > 0:
        for idkl, (q, p) in enumerate(pairs):
            if idkl < len(crosskerr) and abs(crosskerr[idkl]) > 1e-14:
                Hsys -= (2.0 * np.pi * crosskerr[idkl]) * (
                    Amat[q].T @ Amat[q] @ Amat[p].T @ Amat[p]
                )
    if len(Jkl) > 0:
        for idkl, (q, p) in enumerate(pairs):
            if idkl < len(Jkl) and abs(Jkl[idkl]) > 1e-14:
                Hsys += (2.0 * np.pi * Jkl[idkl]) * (
                    Amat[q].T @ Amat[p] + Amat[q] @ Amat[p].T
                )

    Hc_re = [Amat[q] + Amat[q].T for q in range(nqubits)]
    Hc_im = [Amat[q] - Amat[q].T for q in range(nqubits)]
    return Hsys, Hc_re, Hc_im


def drift_diagonal(dims, detuning_radns, selfkerr_radns, crosskerr_radns):
    """Diagonal of the rotating-frame drift Hamiltonian (rad/ns):
        sum_k detune_k n_k - xi_k/2 n_k(n_k-1) - sum_{k<l} xi_kl n_k n_l
    (mastereq.cpp:441-501). Returned as a flat (N,) array.

    This is the closed form used by the tensor (matrix-free) engine; the dense
    engine assembles the same numbers into a matrix diagonal.
    """
    Q = len(dims)
    shape = tuple(dims)
    levels = [np.arange(d, dtype=float) for d in dims]
    grids = np.meshgrid(*levels, indexing="ij") if Q > 0 else []
    diag = np.zeros(shape)
    for k in range(Q):
        nk = grids[k]
        diag += detuning_radns[k] * nk - selfkerr_radns[k] / 2.0 * nk * (nk - 1.0)
    for idkl, (k, l) in enumerate(coupling_pairs(Q)):
        if idkl < len(crosskerr_radns) and abs(crosskerr_radns[idkl]) > 1e-14:
            diag -= crosskerr_radns[idkl] * grids[k] * grids[l]
    return diag.reshape(-1)
