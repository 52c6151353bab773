"""Target gates: the reference's predefined set (gate.cpp:286-571), rotation
into the computational frame, and guard-level lifting.

A gate V is specified in the ESSENTIAL dimensions. Internally it is
 1. rotated: V <- diag(e^{i w_r T}) V with per-row frequency
    w_r = sum_k level_k(r) * gate_rot_freq_k * 2*pi (gate.cpp:88-132);
 2. lifted to full dimensions with identity blocks on guard levels
    (gate.cpp:148-249).

The target states are then V psi0 (Schroedinger) or V rho0 V^dag (Lindblad),
applied directly as (batched) matmuls — no vectorized VxV = conj(V) (x) V
superoperator is ever materialized (the reference builds that N^2 x N^2
sparse matrix, gate.cpp:148-223; the two (N, N) matmuls are cheaper and
exactly equivalent).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..utils.indexing import lift_matrix_ess_to_full, multi_index


def rotate_gate(V_ess: np.ndarray, nessential, gate_rot_freq_ghz, final_time: float) -> np.ndarray:
    """Row-rotate the essential-dim gate: V <- diag(e^{i w_row T}) V where
    w_row = 2*pi * sum_k level_k(row) * gate_rot_freq_k (gate.cpp:96-132)."""
    dim_ess = V_ess.shape[0]
    freqs = 2.0 * np.pi * np.asarray(gate_rot_freq_ghz, dtype=float)
    w = np.zeros(dim_ess)
    for row in range(dim_ess):
        levels = multi_index(row, nessential)
        w[row] = sum(l * f for l, f in zip(levels, freqs))
    phase = np.exp(1j * w * final_time)
    return phase[:, None] * V_ess


def assemble_gate(V_ess: np.ndarray, nlevels, nessential, gate_rot_freq_ghz,
                  final_time: float) -> np.ndarray:
    """Rotated, guard-lifted full-dimension gate matrix."""
    V_rot = rotate_gate(np.asarray(V_ess, dtype=np.complex128), nessential,
                        gate_rot_freq_ghz, final_time)
    return lift_matrix_ess_to_full(V_rot, nlevels, nessential)


# ----- predefined gates in essential dims (gate.cpp:286-571) -----

def xgate() -> np.ndarray:
    return np.array([[0, 1], [1, 0]], dtype=np.complex128)


def ygate() -> np.ndarray:
    return np.array([[0, -1j], [1j, 0]], dtype=np.complex128)


def zgate() -> np.ndarray:
    return np.array([[1, 0], [0, -1]], dtype=np.complex128)


def hadamard() -> np.ndarray:
    return np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)


def cnot() -> np.ndarray:
    V = np.eye(4, dtype=np.complex128)
    V[2:, 2:] = np.array([[0, 1], [1, 0]])
    return V


def swap() -> np.ndarray:
    V = np.eye(4, dtype=np.complex128)
    V[[1, 2], [1, 2]] = 0.0
    V[1, 2] = 1.0
    V[2, 1] = 1.0
    return V


def swap_0q(noscillators: int) -> np.ndarray:
    """SWAP between oscillator 0 and the last one, identity elsewhere
    (gate.cpp SWAP_0Q): acts on 2^Q dim essential space of qubits."""
    dim = 2 ** noscillators
    V = np.zeros((dim, dim), dtype=np.complex128)
    for i in range(dim):
        bits = [(i >> (noscillators - 1 - k)) & 1 for k in range(noscillators)]
        bits[0], bits[-1] = bits[-1], bits[0]
        j = 0
        for b in bits:
            j = (j << 1) | b
        V[j, i] = 1.0
    return V


def cqnot(dim_ess: int) -> np.ndarray:
    """Multi-controlled NOT: identity except swapping the last two basis
    states (gate.cpp CQNOT)."""
    V = np.eye(dim_ess, dtype=np.complex128)
    V[dim_ess - 2: dim_ess, dim_ess - 2: dim_ess] = np.array([[0, 1], [1, 0]])
    return V


def qft(dim: int) -> np.ndarray:
    """Quantum Fourier transform on the full essential dimension."""
    om = np.exp(2j * np.pi / dim)
    j, k = np.meshgrid(np.arange(dim), np.arange(dim), indexing="ij")
    return om ** (j * k) / np.sqrt(dim)


def from_name(name: str, nessential: Sequence[int]) -> np.ndarray:
    """Gate factory matching the config strings (gate.hpp:256 initTargetGate)."""
    dim_ess = int(np.prod(nessential))
    name = name.lower()
    table = {
        "none": None,
        "xgate": xgate,
        "ygate": ygate,
        "zgate": zgate,
        "hadamard": hadamard,
        "cnot": cnot,
        "swap": swap,
    }
    if name in table:
        f = table[name]
        return None if f is None else f()
    if name == "swap0q":
        return swap_0q(len(nessential))
    if name == "cqnot":
        return cqnot(dim_ess)
    if name == "qft":
        return qft(dim_ess)
    raise ValueError(f"unknown gate {name}")


PERMUTATION_GATES = ("xgate", "cnot", "swap", "swap0q", "cqnot")


def permutation_spec(name: str, nessential) -> np.ndarray:
    """Column->row permutation p with V e_j = e_{p[j]} (essential dims) for
    the permutation-structured gates. Used for large-N targets where the
    dense gate matrix cannot be materialized (e.g. CQNOT at N ~ 1e6,
    tests/performance/configs/nlevels_32_32_32_32.cfg)."""
    dim_ess = int(np.prod(nessential))
    name = name.lower()
    p = np.arange(dim_ess, dtype=np.int64)
    if name == "xgate":
        assert dim_ess == 2
        p = np.array([1, 0])
    elif name == "cnot":
        assert dim_ess == 4
        p = np.array([0, 1, 3, 2])
    elif name == "swap":
        assert dim_ess == 4
        p = np.array([0, 2, 1, 3])
    elif name == "swap0q":
        Q = len(nessential)
        for i in range(dim_ess):
            bits = [(i >> (Q - 1 - k)) & 1 for k in range(Q)]
            bits[0], bits[-1] = bits[-1], bits[0]
            j = 0
            for b in bits:
                j = (j << 1) | b
            p[i] = j
    elif name == "cqnot":
        p[dim_ess - 2], p[dim_ess - 1] = dim_ess - 1, dim_ess - 2
    else:
        raise ValueError(f"{name} is not a permutation gate")
    return p


def apply_permutation_gate_to_states(
        name: str, x0: np.ndarray, nlevels, nessential,
        gate_rot_freq_ghz, final_time: float, lindblad: bool) -> np.ndarray:
    """Target batch V x0 (Schroedinger) or V rho0 V^dag (Lindblad) without
    materializing the gate, for permutation gates incl. rotation and
    guard-level lifting. x0: (B, N) or (B, N, N) complex numpy."""
    from ..utils.indexing import (ess_to_full_map, essential_mask,
                                  map_full_to_ess, multi_index)
    N = int(np.prod(nlevels, dtype=np.int64))
    p = permutation_spec(name, nessential)
    emap = ess_to_full_map(nlevels, nessential)
    emask = essential_mask(nlevels, nessential)

    # full-dim permutation pi (identity on guard) and row phases
    pi = np.arange(N, dtype=np.int64)
    pi[emap] = emap[p]           # column emap[j] -> row emap[p[j]]
    freqs = 2.0 * np.pi * np.asarray(gate_rot_freq_ghz, dtype=float)
    phase = np.ones(N, dtype=np.complex128)
    for pos, r_full in enumerate(emap):
        levels = multi_index(pos, nessential)
        w = sum(l * f for l, f in zip(levels, freqs))
        phase[r_full] = np.exp(1j * w * final_time)

    # V x: out[pi[i]] = phase[pi[i]] * x[i]
    inv = np.empty(N, dtype=np.int64)
    inv[pi] = np.arange(N)
    if lindblad:
        # (V rho V^dag)[a, b] = phase[a] conj(phase[b]) rho[inv[a], inv[b]]
        out = x0[:, inv][:, :, inv]
        out = out * phase[None, :, None] * np.conj(phase)[None, None, :]
        return out
    out = x0[:, inv] * phase[None, :]
    return out


def read_gate_file(path: str, dim_ess: int) -> np.ndarray:
    """File format: column-wise vectorization, all real parts then all
    imaginary parts, one value per line (quandary.py:557-562)."""
    vals = np.loadtxt(path).reshape(-1)
    n2 = dim_ess * dim_ess
    assert vals.size >= 2 * n2, f"gate file {path} too short"
    re = vals[:n2].reshape(dim_ess, dim_ess, order="F")
    im = vals[n2: 2 * n2].reshape(dim_ess, dim_ess, order="F")
    return re + 1j * im
