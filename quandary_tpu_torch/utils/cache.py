"""Where the port's native libraries are built: the counterpart of the
reference's persistent compilation cache (quandary_tpu/utils/cache.py).

The CUDA sources (ops/cuda_build.py) and the native IO library
(io/native.py) are compiled at first use into one directory, under names
keyed on a hash of their sources, so that every later process of the same
checkout loads them without compiling. Every library is compiled from the
package's own sources: the directory only keeps what was built.

Environment:
    QTPU_BUILD_DIR=path    build into `path` (default: build/quandary_tpu_torch/
                           beside the package, which .gitignore lists)
    QTPU_NO_BUILD_CACHE=1  build into a fresh directory of this process
                           (under TMPDIR), removed when it exits

Builds write through a temporary file named by the process id and rename
it into place, so that several ranks building at once do not collide.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "quandary_tpu_torch")
_process_dir = None


def build_dir() -> str:
    """The directory the libraries are built into and loaded from (not
    created here, but for the off switch's own directory). ops/cuda_build.py
    reads it once per process, as BUILD_DIR."""
    global _process_dir
    if os.environ.get("QTPU_NO_BUILD_CACHE"):
        if _process_dir is None:
            _process_dir = tempfile.mkdtemp(prefix="quandary_tpu_torch_build_")
            atexit.register(shutil.rmtree, _process_dir, ignore_errors=True)
        return _process_dir
    return os.environ.get("QTPU_BUILD_DIR") or DEFAULT_DIR
