"""Essential/guard level index maps for composite qudit systems.

A composite system of Q oscillators with ``nlevels[k]`` total and
``nessential[k] <= nlevels[k]`` essential levels has a full Hilbert dimension
N = prod(nlevels) and an essential ("computational") dimension
N_e = prod(nessential). States, gates and initial conditions are specified in
the essential dimensions and lifted into the full dimensions by these maps.

Semantics match the reference implementation (util.cpp:155-278 in
LLNL/Quandary) and are exhaustively unit-tested against a brute-force
multi-index construction. All functions here are pure numpy (host-side
precomputation); the resulting index arrays are consumed by torch code.

Index convention: global index i enumerates the tensor product in row-major
(C) order over oscillators 0..Q-1, i.e. oscillator 0 is the slowest axis:
    i = sum_k level_k * prod_{j>k} nlevels[j].
"""

from __future__ import annotations

import numpy as np


def multi_index(i: int, dims) -> tuple:
    """Decompose global index into per-oscillator levels (row-major).

    Mirrors quandary.py:1069-1081 (map_to_oscillators).
    """
    out = []
    rem = int(i)
    for k in range(len(dims)):
        post = int(np.prod(dims[k + 1:], dtype=np.int64)) if k + 1 < len(dims) else 1
        out.append(rem // post)
        rem = rem % post
    return tuple(out)


def flat_index(levels, dims) -> int:
    """Inverse of :func:`multi_index`."""
    idx = 0
    for k, l in enumerate(levels):
        post = int(np.prod(dims[k + 1:], dtype=np.int64)) if k + 1 < len(dims) else 1
        idx += int(l) * post
    return idx


def map_ess_to_full(i: int, nlevels, nessential) -> int:
    """Map an index in essential dims to the full-dim index (util.cpp:155)."""
    levels = multi_index(i, nessential)
    return flat_index(levels, nlevels)


def map_full_to_ess(i: int, nlevels, nessential) -> int:
    """Map full-dim index to essential index, or -1 for guard rows (util.cpp:177)."""
    levels = multi_index(i, nlevels)
    for k, l in enumerate(levels):
        if l >= nessential[k]:
            return -1
    return flat_index(levels, nessential)


def is_essential(i: int, nlevels, nessential) -> bool:
    """True if every oscillator level of index i is essential (util.cpp:237)."""
    levels = multi_index(i, nlevels)
    return all(l < ne for l, ne in zip(levels, nessential))


def is_guard_level(i: int, nlevels, nessential) -> bool:
    """True if index i occupies the last, non-essential level of at least one
    oscillator (util.cpp:259). Note: only the HIGHEST level of an oscillator
    counts as "the guard level" for the leakage penalty.
    """
    levels = multi_index(i, nlevels)
    for l, nl, ne in zip(levels, nlevels, nessential):
        if l == nl - 1 and l >= ne:
            return True
    return False


def _levels_of_all(dims) -> list:
    """Per-oscillator level arrays for ALL flat indices, vectorized:
    levels[k][i] = level of oscillator k at flat index i."""
    n = int(np.prod(dims, dtype=np.int64))
    idx = np.arange(n, dtype=np.int64)
    out = []
    for k in range(len(dims)):
        post = int(np.prod(dims[k + 1:], dtype=np.int64)) if k + 1 < len(dims) else 1
        out.append((idx // post) % dims[k])
    return out


def ess_to_full_map(nlevels, nessential) -> np.ndarray:
    """Vector of full-dim indices for all essential-dim indices (len N_e)."""
    levels = _levels_of_all(nessential)
    out = np.zeros(int(np.prod(nessential, dtype=np.int64)), dtype=np.int64)
    for k in range(len(nlevels)):
        post = int(np.prod(nlevels[k + 1:], dtype=np.int64)) if k + 1 < len(nlevels) else 1
        out += levels[k] * post
    return out


def essential_mask(nlevels, nessential) -> np.ndarray:
    """Boolean mask over full-dim indices: True where index is essential."""
    levels = _levels_of_all(nlevels)
    mask = np.ones(int(np.prod(nlevels, dtype=np.int64)), dtype=bool)
    for k, ne in enumerate(nessential):
        mask &= levels[k] < ne
    return mask


def guard_mask(nlevels, nessential) -> np.ndarray:
    """Boolean mask over full-dim indices: True where index is a guard level
    — the LAST, non-essential level of at least one oscillator (used by the
    leakage-prevention penalty, timestepper.cpp:272-295)."""
    levels = _levels_of_all(nlevels)
    mask = np.zeros(int(np.prod(nlevels, dtype=np.int64)), dtype=bool)
    for k, (nl, ne) in enumerate(zip(nlevels, nessential)):
        if nl - 1 >= ne:
            mask |= levels[k] == nl - 1
    return mask


def lift_matrix_ess_to_full(V_ess: np.ndarray, nlevels, nessential) -> np.ndarray:
    """Lift an essential-dim matrix to full dims, inserting identity on
    guard rows/columns (gate.cpp:224-249, Schroedinger branch).

    Returns V_full with V_full[ess, ess] = V_ess and V_full[g, g] = 1 for
    non-essential g; all cross terms zero.
    """
    n = int(np.prod(nlevels, dtype=np.int64))
    emap = ess_to_full_map(nlevels, nessential)
    V_full = np.zeros((n, n), dtype=np.result_type(V_ess.dtype, np.complex128))
    mask = essential_mask(nlevels, nessential)
    for g in np.nonzero(~mask)[0]:
        V_full[g, g] = 1.0
    V_full[np.ix_(emap, emap)] = V_ess
    return V_full


def lift_vector_ess_to_full(v_ess: np.ndarray, nlevels, nessential) -> np.ndarray:
    """Lift an essential-dim vector to full dims (zeros on guard levels)."""
    n = int(np.prod(nlevels, dtype=np.int64))
    emap = ess_to_full_map(nlevels, nessential)
    out = np.zeros((n,), dtype=np.result_type(v_ess.dtype, np.complex128))
    out[emap] = v_ess
    return out
