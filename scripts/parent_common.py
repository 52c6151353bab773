"""What the parent-comparison and split scripts share (stream_parent.py,
streamk_mid_parent.py, rho_mid_parent.py, stream_mid_parent.py and the
*_split.py scripts): building another commit's CUDA source (or a variant of
one) into a library of its own and binding it, the card's name and power
limit, CUDA-event timing interleaved, and variants of a source by text
substitution.

A parent is unpacked beside the checkout first, for example:

    mkdir -p build/parent && git archive HEAD~1 quandary_tpu_torch/csrc \\
        | tar -x -C build/parent
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from quandary_tpu_torch.ops import cuda_build  # noqa: E402


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def nvcc(src, out, *flags, verbose=False):
    """Build `src` into the shared library `out` (cuda_build's nvcc command
    and `flags`) and load it: (lib, compiler output)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    res = subprocess.run(cuda_build.nvcc_command(src, out, verbose)
                         + list(flags), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(out), res.stdout + res.stderr


def build_parent(src, name, bind=None, verbose=False):
    """Compile the source at `src` (its headers beside it) into its own
    library build/quandary_tpu_torch/<name>/lib<name>.so, load it and
    bind it: bind(lib, text of the source). With `verbose` also return
    ptxas's report."""
    out = os.path.join(cuda_build.BUILD_DIR, name, f"lib{name}.so")
    lib, log = nvcc(src, out, verbose=verbose)
    if bind is not None:
        with open(src) as f:
            bind(lib, f.read())
    return (lib, log) if verbose else lib


def interleaved(runs, first, reps):
    """CUDA-event ms of each run in the order first, the others, the others
    reversed, first: {name: [ms, ms]}."""
    import chip_smoke as cs
    rest = [k for k in runs if k != first]
    ms = {k: [] for k in runs}
    for k in [first] + rest + rest[::-1] + [first]:
        ms[k].append(cs.event_ms(runs[k], reps))
    torch.cuda.synchronize()
    return ms


def variant_sources(src, variants, after=None, until=None, stem=None):
    """{name: path of its source} for {name: ((old, new), ...)}: each
    variant is `src` with every `old` (which must occur once) replaced by
    its `new`, written beside the source as <stem>_<name>.cu (its headers
    are included by relative path); with `after` (and `until`), the
    substitutions touch only the text from its first occurrence on (up to
    the first occurrence of `until` after it)."""
    with open(src) as f:
        text0 = f.read()
    stem = stem or os.path.splitext(os.path.basename(src))[0] + "_split"
    paths = {}
    for name, subs in variants.items():
        head, text, tail = "", text0, ""
        if after is not None:
            head, text = text[:text.index(after)], text[text.index(after):]
        if until is not None:
            text, tail = text[:text.index(until)], text[text.index(until):]
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"{name}: {src} does not hold {old!r} once")
            text = text.replace(old, new)
        paths[name] = os.path.join(os.path.dirname(src),
                                   f"{stem}_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(head + text + tail)
    return paths
