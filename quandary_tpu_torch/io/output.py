"""Output-file writers byte-format-compatible with the reference
(output.cpp), so downstream tooling (gnuplot scripts, quandary.py
get_results parsers) keeps working.

Files: optim_history.dat, params.dat, grad.dat, control<k>.dat. The
trajectory writers (expected energy, population, full state) of
quandary_tpu/io/output.py are not ported yet.
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
