"""Initial-condition batch constructors (optimtarget.cpp:73-197, 450-698).

All generators return a numpy batch of complex states — (B, N) state vectors
for the Schroedinger solver, (B, N, N) density matrices for the Lindblad
solver — plus the per-initial-condition output IDs used in trajectory file
names. The whole batch is propagated at once (vmap-free batched matmuls),
replacing the reference's comm_init loop over initial conditions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.indexing import map_ess_to_full, multi_index, flat_index


def _subsystem_basis_indices(nlevels, nessential, osc_ids) -> np.ndarray:
    """Full-dim indices of the essential basis states spanned in the selected
    subsystems (others in ground state), enumerated exactly like the
    reference's iinit * dim_post + mapEssToFull (optimtarget.cpp:574-603).

    Requires osc_ids to be consecutive starting from some prefix — matches the
    reference's config format of a consecutive ID list.
    """
    osc_ids = list(osc_ids)
    ness_sel = [nessential[k] for k in osc_ids]
    nsel = int(np.prod(ness_sel, dtype=np.int64))
    out = np.zeros(nsel, dtype=np.int64)
    for i in range(nsel):
        levels_sel = multi_index(i, ness_sel)
        levels = [0] * len(nlevels)
        for pos, k in enumerate(osc_ids):
            levels[k] = levels_sel[pos]
        ess_idx = flat_index(levels, nessential)
        out[i] = map_ess_to_full(ess_idx, nlevels, nessential)
    return out


def ninit_for(initcond_type: str, nlevels, nessential, osc_ids, lindblad: bool) -> int:
    """Number of initial conditions for each type (main.cpp:89-131)."""
    t = initcond_type
    ness_sel = int(np.prod([nessential[k] for k in osc_ids], dtype=np.int64))
    if t in ("file", "pure", "ensemble", "performance"):
        return 1
    if t == "3states":
        return 3
    if t == "Nplus1":
        return int(np.prod(nlevels, dtype=np.int64)) + 1
    if t == "diagonal":
        return ness_sel
    if t == "basis":
        return ness_sel * ness_sel if lindblad else ness_sel
    raise ValueError(f"unknown initial condition type {t}")


def build_initial_states(
    initcond_type: str,
    nlevels: Sequence[int],
    nessential: Sequence[int],
    osc_ids: Sequence[int],
    lindblad: bool,
    pure_levels: Optional[Sequence[int]] = None,
    from_file_state: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Build the (B, ...) initial-state batch and the output file IDs.

    pure_levels: per-oscillator levels for 'pure' type.
    from_file_state: essential-dim complex state (vector or density matrix)
        for 'file' type; lifted to full dims here.
    """
    N = int(np.prod(nlevels, dtype=np.int64))
    t = initcond_type
    states = []
    initids = []

    def vec_or_dm(idx_or_vec):
        """Promote a pure full-dim index or vector to the solver's state."""
        if np.isscalar(idx_or_vec):
            v = np.zeros(N, dtype=np.complex128)
            v[int(idx_or_vec)] = 1.0
        else:
            v = np.asarray(idx_or_vec, dtype=np.complex128)
        if lindblad:
            return np.outer(v, v.conj())
        return v

    if t == "pure":
        levels = list(pure_levels) if pure_levels is not None else [0] * len(nlevels)
        idx = flat_index(levels, nlevels)  # spanned in FULL levels (optimtarget.cpp:80-93)
        states.append(vec_or_dm(idx))
        initids.append(0)

    elif t == "file":
        assert from_file_state is not None
        ess_state = np.asarray(from_file_state, dtype=np.complex128)
        emap = np.array([map_ess_to_full(i, nlevels, nessential)
                         for i in range(int(np.prod(nessential, dtype=np.int64)))])
        if lindblad:
            if ess_state.ndim == 1:
                ess_state = np.outer(ess_state, ess_state.conj())
            rho = np.zeros((N, N), dtype=np.complex128)
            rho[np.ix_(emap, emap)] = ess_state
            states.append(rho)
        else:
            v = np.zeros(N, dtype=np.complex128)
            v[emap] = ess_state
            states.append(v)
        initids.append(0)

    elif t == "performance":
        # psi = 1/sqrt(2N) (ones + i ones); Lindblad: rho = diag(1/N)... the
        # reference sets only the diagonal real entries 1/N (optimtarget.cpp:460-481)
        if lindblad:
            states.append(np.eye(N, dtype=np.complex128) / N)
        else:
            states.append((np.ones(N) + 1j * np.ones(N)) / np.sqrt(2.0 * N))
        initids.append(0)

    elif t == "ensemble":
        assert lindblad, "ensemble initial state requires the Lindblad solver"
        sub_idx = _subsystem_basis_indices(nlevels, nessential, osc_ids)
        dsub = len(sub_idx)
        rho = np.zeros((N, N), dtype=np.complex128)
        for a in range(dsub):
            for b in range(a, dsub):
                i, j = sub_idx[a], sub_idx[b]
                if a == b:
                    rho[i, j] = 1.0 / dsub
                else:
                    rho[i, j] = (0.5 + 0.5j) / (dsub * dsub)
                    rho[j, i] = (0.5 - 0.5j) / (dsub * dsub)
        states.append(rho)
        initids.append(0)

    elif t == "3states":
        assert lindblad
        rho1 = np.diag(2.0 * (N - np.arange(N)) / (N * (N + 1.0))).astype(np.complex128)
        rho2 = np.full((N, N), 1.0 / N, dtype=np.complex128)
        rho3 = (np.eye(N) / N).astype(np.complex128)
        states.extend([rho1, rho2, rho3])
        initids.extend([1, 2, 3])

    elif t == "Nplus1":
        assert lindblad
        for j in range(N):
            states.append(np.outer(np.eye(N)[j], np.eye(N)[j]).astype(np.complex128))
            initids.append(j)
        states.append(np.full((N, N), 1.0 / N, dtype=np.complex128))
        initids.append(N)

    elif t == "diagonal" or (t == "basis" and not lindblad):
        sub_idx = _subsystem_basis_indices(nlevels, nessential, osc_ids)
        ninit = len(sub_idx)
        for i, idx in enumerate(sub_idx):
            states.append(vec_or_dm(int(idx)))
            initids.append(i * ninit + i if lindblad else i)

    elif t == "basis":  # Lindblad basis matrices B_kj (optimtarget.cpp:605-690)
        sub_idx = _subsystem_basis_indices(nlevels, nessential, osc_ids)
        nsub = len(sub_idx)
        for iinit in range(nsub * nsub):
            k = iinit % nsub
            j = iinit // nsub
            kf, jf = int(sub_idx[k]), int(sub_idx[j])
            rho = np.zeros((N, N), dtype=np.complex128)
            if k == j:
                rho[kf, kf] = 1.0
            elif k < j:   # B_kj = 1/2(E_kk + E_jj) + 1/2(E_kj + E_jk)
                rho[kf, kf] = 0.5
                rho[jf, jf] = 0.5
                rho[kf, jf] = 0.5
                rho[jf, kf] = 0.5
            else:         # B_kj = 1/2(E_kk + E_jj) + i/2(E_jk - E_kj)
                rho[kf, kf] = 0.5
                rho[jf, jf] = 0.5
                rho[kf, jf] = -0.5j
                rho[jf, kf] = 0.5j
            states.append(rho)
            initids.append(j * nsub + k)
    else:
        raise ValueError(f"unknown initial condition type {t}")

    return np.stack(states, axis=0), initids
