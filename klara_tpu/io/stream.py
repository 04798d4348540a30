"""In-loop host streaming of draws (reference iostream destination).

Reference: outopts ``:destination=>:iostream`` streams each saved draw to
per-field CSV files during the run (src/jobs/BasicMCJob.jl:203-208,
src/iostreams/), avoiding memory pressure for long chains.

Mechanism: `jax.experimental.io_callback` (ordered) invoked
from inside the compiled scan — the device pushes each saved draw to the
host asynchronously; the host appends to open file handles.  This is the
SURVEY.md §2.2 "Host CSV writer via io_callback" component.

Cost model: one host round-trip per CHUNK of draws (MCJob accumulates
saved draws in a small device ring buffer and flushes via `append_block`
every `stream_chunk` steps); use the in-memory trace
(destination='nstate') when draws fit on device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class StreamingWriter:
    """Appends rows of draws to one file per field.

    ``sample_fields`` (optional) marks which field names are monitored
    samples (the rest are diagnostics); on close a ``manifest.json`` +
    per-field ``.shape`` sidecars are written so the directory round-trips
    through ``klara_tpu.io.read_chain`` into a typed Chain (reference
    `read` → NState, BasicContParamIOStream.jl:203-262)."""

    def __init__(
        self,
        filepath: str,
        filesuffix: str = "csv",
        flush: bool = False,
        sample_fields: Optional[set] = None,
    ):
        self.filepath = filepath
        self.filesuffix = filesuffix
        self.flush = flush
        self.sample_fields = sample_fields
        self._handles: Dict[str, object] = {}
        self._shapes: Dict[str, tuple] = {}
        self._rows: Dict[str, int] = {}
        os.makedirs(filepath, exist_ok=True)

    def _handle(self, name):
        if name not in self._handles:
            self._handles[name] = open(
                os.path.join(self.filepath, f"{name}.{self.filesuffix}"), "a"
            )
        return self._handles[name]

    def append(self, do_save, fields: Dict[str, np.ndarray]) -> np.int32:
        """Host-side callback body: append one row per field when do_save."""
        if bool(do_save):
            new_field = False
            for name, arr in fields.items():
                arr = np.asarray(arr, dtype=np.float64)
                if name not in self._shapes:
                    self._shapes[name] = arr.shape
                    new_field = True
                self._rows[name] = self._rows.get(name, 0) + 1
                row = ",".join(f"{v:.9g}" for v in arr.reshape(-1))
                h = self._handle(name)
                h.write(row + "\n")
                if self.flush:
                    h.flush()
            if new_field:
                # eager manifest/sidecars so a crashed run is still
                # readable (read_chain_csv fixes the draws-axis length
                # from the data); refreshed with final counts on close()
                self._write_sidecars()
        return np.int32(0)

    def append_block(self, count, fields: Dict[str, np.ndarray]) -> np.int32:
        """Host-side callback body for CHUNKED streaming: ``fields`` arrays
        carry a leading chunk axis; append the first ``count`` rows of each.

        One host round-trip per chunk instead of per draw — a per-step
        ordered io_callback costs a device->host round-trip per
        iteration, which stalls the device; chunked dumps amortise it
        (SURVEY.md §2.2 'chunked dumps')."""
        count = int(count)
        if count > 0:
            new_field = False
            for name, arr in fields.items():
                arr = np.asarray(arr, dtype=np.float64)[:count]
                if name not in self._shapes:
                    self._shapes[name] = arr.shape[1:]
                    new_field = True
                self._rows[name] = self._rows.get(name, 0) + count
                h = self._handle(name)
                flat = arr.reshape(count, -1)
                h.write(
                    "\n".join(
                        ",".join(f"{v:.9g}" for v in row) for row in flat
                    )
                    + "\n"
                )
                if self.flush:
                    h.flush()
            if new_field:
                self._write_sidecars()
        return np.int32(0)

    def _write_sidecars(self):
        from klara_tpu.io.csvio import _write_manifest

        shapes = {
            name: (self._rows.get(name, 0),) + shape
            for name, shape in self._shapes.items()
        }
        for name, shape in shapes.items():
            with open(os.path.join(self.filepath, f"{name}.shape"), "w") as f:
                f.write(",".join(map(str, shape)))
        if self.sample_fields is None:
            samples, diagnostics = list(self._shapes), []
        else:
            samples = [n for n in self._shapes if n in self.sample_fields]
            diagnostics = [n for n in self._shapes if n not in self.sample_fields]
        _write_manifest(self.filepath, samples, diagnostics, shapes, self.filesuffix)

    def close(self):
        for h in self._handles.values():
            h.close()
        self._handles.clear()
        if self._shapes:
            self._write_sidecars()  # refresh with final row counts

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
