"""Carrying a problem across: build the port's Setup from plain data.

``setup_from_arrays(d)`` takes a dict of numpy arrays and scalars (what any
other front end, a saved file, or the JAX package's Setup can be reduced
to) and returns :class:`quandary_tpu_torch.problem.Setup`:

* the model: ``stack`` (K, N, N) complex, ``etas``, ``dims``, ``n_osc``,
  and optionally ``collapse_ops`` and ``lindblad``; or, for the structured
  engines, ``structured``: a dict of the StructuredModel's fields (dims,
  detune, selfkerr, crosskerr, jkl, etas, jc_pairs, gamma_decay,
  gamma_dephase, lindblad), as ``dataclasses.asdict`` gives them;
* ``oscillators``: a list of dicts with ``segments`` (each a dict of
  ControlSegment fields), ``carrier_freqs`` and ``enforce_bc``;
* ``dtype``: 'complex64' or 'complex128';
* every other key is a Setup field of the same name (initial conditions,
  targets, objective, the gammas, the solver settings, ``fused_mode``, the
  kernel family 'streamk' | 'stream' | 'chunk' that the JAX package calls
  ``pallas_mode``, for open systems ``fused_rho``, the route gate
  'auto' | 'rho' | 'superop' that the JAX package calls ``pallas_rho``,
  and the time-parallel scan's ``time_parallel`` ('auto' | True | False)
  and ``time_parallel_budget``, under the JAX package's names).

The control vector keeps the JAX package's layout (that of params.dat), so
parameters carry across unchanged. An ensemble of system realizations
(optim/robust.py) carries across as a list of such dicts, one
``setup_from_arrays`` call each: the samples differ only in ``stack``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.hamiltonian import HamiltonianModel
from .ops.tensor_rhs import StructuredModel
from .problem import Setup
from .utils.splines import ControlSegment, OscillatorControl

_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def _structured(m: dict) -> StructuredModel:
    floats = lambda v: tuple(float(x) for x in v)
    return StructuredModel(
        dims=tuple(int(n) for n in m["dims"]),
        detune=floats(m["detune"]), selfkerr=floats(m["selfkerr"]),
        crosskerr=floats(m["crosskerr"]), jkl=floats(m["jkl"]),
        etas=floats(m["etas"]),
        jc_pairs=tuple((int(k), int(l)) for k, l in m["jc_pairs"]),
        gamma_decay=floats(m["gamma_decay"]),
        gamma_dephase=floats(m["gamma_dephase"]),
        lindblad=bool(m["lindblad"]))


def setup_from_arrays(d: dict) -> Setup:
    d = dict(d)
    if "structured" in d:
        model = _structured(d.pop("structured"))
    else:
        model = HamiltonianModel(
            dims=tuple(int(n) for n in d.pop("dims")),
            stack=np.asarray(d.pop("stack")),
            etas=np.asarray(d.pop("etas"), dtype=float),
            n_osc=int(d.pop("n_osc")),
            collapse_ops=tuple(np.asarray(L)
                               for L in d.pop("collapse_ops", ())),
            lindblad=bool(d.pop("lindblad", False)),
        )
    oscs = tuple(
        OscillatorControl(
            segments=tuple(ControlSegment(**seg) for seg in o["segments"]),
            carrier_freqs=tuple(float(f) for f in o["carrier_freqs"]),
            enforce_bc=bool(o.get("enforce_bc", False)))
        for o in d.pop("oscillators", ()))
    dtype = _DTYPES[str(d.pop("dtype", "complex128"))]
    return Setup(model=model, oscillators=oscs, dtype=dtype, **d)
