"""Output-file writers byte-format-compatible with the reference
(output.cpp), so downstream tooling (gnuplot scripts, quandary.py
get_results parsers) keeps working.

Files: optim_history.dat, params.dat, grad.dat, control<k>.dat,
expected<k>.iinit####.dat, population<k>.iinit####.dat,
expected_composite / population_composite, rho_Re/Im.iinit####.dat,
config_log.dat. The writers take numpy arrays or tensors on any device.
"""

from __future__ import annotations

import os

import numpy as np

OPTIM_HEADER = ("#\"iter\"    \"Objective\"           \"||Pr(grad)||\"        "
                "   \"LS step\"           \"F_avg\"           \"Terminal cost\""
                "         \"Tikhonov-regul\"        \"Penalty-term\"          "
                "\"State variation\"        \"Energy-term\"           "
                "\"Control variation\"\n")


OPTIM_ROW_FMT = ("%05d  %1.14e  %1.14e  %.8f  %1.14e  %1.14e  %1.14e  "
                 "%1.14e  %1.14e  %1.14e  %1.14e\n")


def _host(a) -> np.ndarray:
    """Tensor (any device) or array -> numpy."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def write_optim_history(path: str, rows) -> None:
    """11-column format (output.cpp:80-86)."""
    with open(path, "w", newline="\n") as f:
        f.write(OPTIM_HEADER)
        for r in rows:
            t = r.as_tuple() if hasattr(r, "as_tuple") else tuple(r)
            f.write(OPTIM_ROW_FMT % t)


class OptimHistoryWriter:
    """Streaming optim_history.dat writer: one row appended + flushed per
    monitored iteration, the reference's writeOptimFile semantics
    (output.cpp:80-86, fopen at startup output.cpp:35, fflush per row), so
    a killed optimization leaves a valid, current history file behind.
    `append=True` (warm restart) keeps the existing rows and skips the
    header."""

    def __init__(self, path: str, append: bool = False):
        exists = os.path.exists(path)
        self._f = open(path, "a" if append else "w", newline="\n")
        if not (append and exists):
            self._f.write(OPTIM_HEADER)
            self._f.flush()

    def write_row(self, row) -> None:
        t = row.as_tuple() if hasattr(row, "as_tuple") else tuple(row)
        self._f.write(OPTIM_ROW_FMT % t)
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def write_params(path: str, params) -> None:
    with open(path, "w", newline="\n") as f:
        for v in _host(params).reshape(-1):
            f.write("%1.14e\n" % float(v))


def write_gradient(path: str, grad) -> None:
    write_params(path, grad)


def write_controls(datadir: str, ts, p, q, flab,
                   output_frequency: int = 1) -> None:
    """control<k>.dat: time, p/2pi, q/2pi, f/2pi (output.cpp:136-154).
    p, q, flab: (nt, Q) arrays or tensors in rad/ns."""
    ts, p, q, flab = (_host(a) for a in (ts, p, q, flab))
    twopi = 2.0 * np.pi
    for k in range(p.shape[1]):
        path = os.path.join(datadir, f"control{k}.dat")
        with open(path, "w", newline="\n") as f:
            f.write("#\"time\"         \"p(t) (rotating)\"          "
                    "\"q(t) (rotating)\"         \"f(t) (labframe)\"\n")
            for i in range(0, len(ts), output_frequency):
                f.write("% 1.8f   % 1.14e   % 1.14e   % 1.14e \n"
                        % (ts[i], p[i, k] / twopi, q[i, k] / twopi,
                           flab[i, k] / twopi))


def write_expected_energy(datadir: str, k: int, initid: int, ts, values,
                          output_frequency: int = 1,
                          composite: bool = False) -> None:
    """expected<k>.iinit####.dat (output.cpp:166-177, 208-218)."""
    ts, values = _host(ts), _host(values)
    name = (f"expected_composite.iinit{initid:04d}.dat" if composite
            else f"expected{k}.iinit{initid:04d}.dat")
    with open(os.path.join(datadir, name), "w", newline="\n") as f:
        f.write("#\"time\"      \"expected energy level\"\n")
        for i in range(0, len(ts), output_frequency):
            f.write("%.8f %1.14e\n" % (ts[i], values[i]))


def write_population(datadir: str, k: int, initid: int, ts, pops,
                     output_frequency: int = 1,
                     composite: bool = False) -> None:
    """population<k>.iinit####.dat: time then per-level populations
    (output.cpp:180-243). pops: (nt, nlevels)."""
    ts, pops = _host(ts), _host(pops)
    if composite:
        name = f"population_composite.iinit{initid:04d}.dat"
        with open(os.path.join(datadir, name), "w", newline="\n") as f:
            f.write("#\"time\"      \"population\"\n")
            for i in range(0, len(ts), output_frequency):
                f.write("%.8f  " % ts[i]
                        + "".join("%1.14e  " % v for v in pops[i]) + "\n")
    else:
        name = f"population{k}.iinit{initid:04d}.dat"
        with open(os.path.join(datadir, name), "w", newline="\n") as f:
            f.write("#\"time\"      \"diagonal of the density matrix\"\n")
            for i in range(0, len(ts), output_frequency):
                f.write("%.8f " % ts[i]
                        + "".join(" %1.14e" % v for v in pops[i]) + "\n")


def write_fullstate(datadir: str, initid: int, ts, states, lindblad: bool,
                    output_frequency: int = 1, prefix: str = "rho") -> None:
    """rho_Re/Im.iinit####.dat: time then the vectorized state per row
    (output.cpp:246-267). states: (nt, N) or (nt, N, N) complex; Lindblad
    states are vectorized COLUMN-major (the reference stores vec(rho))."""
    ts, states = _host(ts), _host(states)
    nt = states.shape[0]
    if lindblad and states.ndim == 3:
        flat = states.transpose(0, 2, 1).reshape(nt, -1)
    else:
        flat = states
    path_re = os.path.join(datadir, f"{prefix}_Re.iinit{initid:04d}.dat")
    path_im = os.path.join(datadir, f"{prefix}_Im.iinit{initid:04d}.dat")

    from . import native
    re = np.ascontiguousarray(flat.real)
    im = np.ascontiguousarray(flat.imag)
    if (native.write_state_rows(path_re, "", ts, re, output_frequency)
            and native.write_state_rows(path_im, "", ts, im,
                                        output_frequency)):
        return
    with open(path_re, "w", newline="\n") as fu, \
            open(path_im, "w", newline="\n") as fv:
        for i in range(0, nt, output_frequency):
            fu.write("%.8f  " % ts[i]
                     + "".join("%1.10e  " % v for v in re[i]) + "\n")
            fv.write("%.8f  " % ts[i]
                     + "".join("%1.10e  " % v for v in im[i]) + "\n")


def write_config_log(path: str, entries) -> None:
    """config_log.dat: one 'key = value' line per consumed config entry
    (main.cpp:382-393)."""
    with open(path, "w", newline="\n") as f:
        for k, v in entries:
            f.write(f"{k} = {v}\n")
