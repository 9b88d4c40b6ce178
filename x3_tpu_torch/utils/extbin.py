"""Optional external comparison binaries (x3_tpu.utils.extbin).

The reference's Rust `x3` binary (`x3 --input FILE --output FILE`) and
`flac --compression-level-0`, the reference's comparison codec, are found
wherever they exist and never fetched:

* set ``X3_REFERENCE_BIN`` (or put ``x3`` on PATH) and the port's
  ``tools/roundtrip_corpus.py`` / ``tools/fuzz_differential.py`` add a
  byte-level comparison of whole archives against the reference binary
  plus cross-decodes in both directions;
* set ``FLAC_BIN`` (or put ``flac`` on PATH) and ``tools/bench_files.py``
  fills its flac columns.

Without them those checks are off and the tools say so.
"""

from __future__ import annotations

import os
import shutil
import subprocess


def _executable(cand: str | None) -> str | None:
    if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    return None


def find_reference_x3() -> str | None:
    """Path to the reference `x3` binary (X3_REFERENCE_BIN beats PATH)."""
    return _executable(os.environ.get("X3_REFERENCE_BIN") or shutil.which("x3"))


def find_flac() -> str | None:
    """Path to a `flac` binary (FLAC_BIN beats PATH)."""
    return _executable(os.environ.get("FLAC_BIN") or shutil.which("flac"))


def ref_convert(binary: str, src, dst) -> None:
    """One reference-CLI conversion (--input/--output; the direction
    follows the extensions, as in the port's CLI)."""
    subprocess.run(
        [binary, "--input", str(src), "--output", str(dst)],
        check=True,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        timeout=600,
    )
