"""Time-step estimation and carrier-wave frequency selection.

Behavioral spec: quandary.py:896-1060 — the time grid resolves the fastest
period of (Hsys + estimated control) with Pmin points per period, and the
carrier waves are the dressed transition frequencies between essential
states that the control operators connect, filtered by coupling amplitude
and mutual proximity. Carrier parity with the reference is REQUIRED (the
derived nsteps and pulse frequencies feed every downstream example), so the
selection criteria match exactly; the implementation is vectorized here.
"""

from __future__ import annotations

import numpy as np

from .indexing import multi_index


def estimate_timesteps(*, T: float, Hsys: np.ndarray, Hc_re=(), Hc_im=(),
                       maxctrl_MHz=(), Pmin: int = 40) -> int:
    """Number of IMR steps so the largest eigenfrequency of the worst-case
    Hamiltonian (drift plus controls at their estimated peak amplitude) is
    sampled Pmin times per period."""
    n_ctrl = max(len(Hc_re), len(Hc_im))
    amps_radns = [
        (list(maxctrl_MHz) + [10.0] * n_ctrl)[i] * 2.0 * np.pi / 1e3
        for i in range(n_ctrl)
    ] if len(maxctrl_MHz) else [10.0 * 2.0 * np.pi / 1e3] * n_ctrl

    H = np.asarray(Hsys, dtype=np.complex128).copy()
    for amp, hc in zip(amps_radns, Hc_re):
        if np.size(hc):
            H += amp * np.asarray(hc)
    for amp, hc in zip(amps_radns, Hc_im):
        if np.size(hc):
            H += 1j * amp * np.asarray(hc)

    max_radns = np.abs(np.linalg.eigvals(H)).max()
    return int(np.ceil(T * max_radns * Pmin / (2.0 * np.pi)))


def eigen_and_reorder(H0: np.ndarray, verbose: bool = False):
    """Eigendecomposition of H0 with the eigenpairs permuted so the
    eigenvector matrix is maximally diagonal (each bare state mapped to the
    dressed state it dominates) and signed so the diagonal is positive."""
    evals, evects = np.linalg.eig(np.asarray(H0))
    order = np.argsort(evals)
    evals, evects = evals[order], evects[:, order]

    # row r's dressed partner = the column where |row r| peaks
    assign = np.argmax(np.abs(evects), axis=1)
    if np.unique(assign).size != evects.shape[0]:
        raise ValueError("Permutation of eigen-vector matrix failed")
    evals, evects = evals[assign], evects[:, assign]

    flip = np.where(np.real(np.diagonal(evects)) < 0.0, -1.0, 1.0)
    return evals, evects * flip[None, :]


def get_resonances(*, Ne, Ng, Hsys, Hc_re=(), Hc_im=(), rotfreq=(),
                   cw_amp_thres: float = 1e-7, cw_prox_thres: float = 1e-2,
                   verbose: bool = False, stdmodel: bool = True):
    """Carrier-wave frequencies per oscillator.

    For each control operator (symmetric and antisymmetric part, in that
    order), transformed to the dressed basis, every lower-triangular entry
    (i, j<i) coupling two ESSENTIAL states contributes the dressed
    transition frequency E_i - E_j [GHz] — kept if its coupling amplitude
    reaches cw_amp_thres and no already-kept frequency lies within
    cw_prox_thres. Returns (om, growth_rate) with om[q] at least [0.0].
    """
    n_osc = len(Ne)
    nlevels = [e + g for e, g in zip(Ne, Ng)]

    energies, U = eigen_and_reorder(Hsys, verbose)
    freqs_ghz = np.real(energies) / (2.0 * np.pi)

    # essential-state mask over flat indices, computed once
    n = np.asarray(Hsys).shape[0]
    essential = np.array([
        all(lv < Ne[k] for k, lv in enumerate(multi_index(idx, nlevels)))
        for idx in range(n)
    ])

    om, growth_rate = [], []
    for q in range(n_osc):
        kept_f: list = []
        kept_rate: list = []
        for Hc in (np.asarray(Hc_re[q]), np.asarray(Hc_im[q])):
            dressed = U.conj().T @ Hc @ U
            for i in range(n):
                if not essential[i]:
                    continue
                for j in range(i):
                    coupling = abs(dressed[i, j])
                    if coupling < 1e-14 or not essential[j]:
                        continue
                    df = freqs_ghz[i] - freqs_ghz[j]
                    if abs(df) < 1e-10:
                        df = 0.0
                    if any(abs(df - f) < cw_prox_thres for f in kept_f):
                        continue
                    if coupling < cw_amp_thres:
                        continue
                    kept_f.append(df)
                    kept_rate.append(coupling)
        if kept_f:
            om.append(np.array(kept_f))
            growth_rate.append(np.array(kept_rate))
        else:
            om.append(np.zeros(1))
            growth_rate.append(np.ones(1))
    return om, growth_rate
