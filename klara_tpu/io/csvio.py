"""CSV chain output / read-back with stream control.

Reference: src/iostreams/ — `BasicContParamIOStream` keeps one CSV file
per monitored field (``<field>.csv`` under ``filepath``,
BasicContParamIOStream.jl:75-79), appends a row per draw (:152-159),
supports `mark`/`reset` file-position control (:125-141), and rebuilds an
in-memory chain from the files (:203-262).

Here the same layout is produced from a completed `Chain` (device trace
buffers are the primary storage; files are an export), with each row one
draw and chains laid out as column groups.  A ``manifest.json`` sidecar
records which fields are samples vs diagnostics and their shapes, so
``read_chain`` can rebuild a typed `Chain` that feeds the stats layer
directly.  ``ChainReader`` provides the reference's mark/reset stream
control for incremental consumption of a file that is still being
written.  For in-loop streaming use
klara_tpu.io.stream.StreamingWriter (io_callback path) — its output is
read back by the same functions.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np


def _write_manifest(filepath, samples, diagnostics, shapes, filesuffix="csv"):
    with open(os.path.join(filepath, "manifest.json"), "w") as f:
        json.dump(
            {
                "samples": sorted(samples),
                "diagnostics": sorted(diagnostics),
                "shapes": {k: list(v) for k, v in shapes.items()},
                "filesuffix": filesuffix,
            },
            f,
        )


def _read_manifest(filepath):
    path = os.path.join(filepath, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_chain_csv(chain, filepath: str, filesuffix: str = "csv") -> Dict[str, str]:
    """Write one file per monitored field + diagnostics.

    Array (n_post, n_chains, ...) is flattened per draw to a row of
    n_chains*prod(event_shape) comma-separated values (matching the
    reference's comma-joined `write(iostream, state)` rows)."""
    os.makedirs(filepath, exist_ok=True)
    written = {}
    fields = dict(chain.samples)
    fields.update({k: v for k, v in chain.diagnostics.items()})
    shapes = {}
    for name, arr in fields.items():
        arr = np.asarray(arr)
        flat = arr.reshape(arr.shape[0], -1)
        fname = os.path.join(filepath, f"{name}.{filesuffix}")
        np.savetxt(fname, flat, delimiter=",", fmt="%.9g")
        written[name] = fname
        shapes[name] = arr.shape
        # shape sidecar so read_chain_csv can restore (n_chains, *event)
        with open(os.path.join(filepath, f"{name}.shape"), "w") as f:
            f.write(",".join(map(str, arr.shape)))
    _write_manifest(
        filepath, chain.samples.keys(), chain.diagnostics.keys(), shapes, filesuffix
    )
    return written


def read_chain_csv(filepath: str, fields=None, filesuffix: str = "csv"):
    """Rebuild raw {field: array} from a directory written by
    write_chain_csv / StreamingWriter (reference `read!` low-level path,
    BasicContParamIOStream.jl:161-201).  See ``read_chain`` for the typed
    Chain round-trip."""
    out = {}
    names = fields
    if names is None:
        names = [
            f[: -len(f".{filesuffix}")]
            for f in os.listdir(filepath)
            if f.endswith(f".{filesuffix}")
        ]
    for name in names:
        # ndmin=2 keeps a single-row file as (1, D), not a (D,) vector
        flat = np.loadtxt(
            os.path.join(filepath, f"{name}.{filesuffix}"), delimiter=",", ndmin=2
        )
        shape_file = os.path.join(filepath, f"{name}.shape")
        if os.path.exists(shape_file):
            with open(shape_file) as f:
                shape = tuple(int(s) for s in f.read().split(","))
            # tolerate stale row counts (e.g. a sidecar written eagerly at
            # stream start, or a run that died mid-stream): trust the data
            # for the draws axis, the sidecar for the event shape
            if int(np.prod(shape)) != flat.size:
                shape = (flat.shape[0],) + shape[1:]
            flat = flat.reshape(shape)
        out[name] = flat
    return out


def read_chain(
    filepath: str,
    samples: Optional[Sequence[str]] = None,
    diagnostics: Optional[Sequence[str]] = None,
    filesuffix: str = "csv",
):
    """Rebuild a typed `Chain` from a CSV directory — the reference's
    ``read(iostream, ...) -> NState`` (BasicContParamIOStream.jl:203-262).

    Field classification comes from ``manifest.json`` (written by both
    write_chain_csv and StreamingWriter) unless overridden.  The returned
    Chain has ``final_state=None`` and feeds the stats layer directly
    (ess/mean/acceptance/...).
    """
    from klara_tpu.jobs.chain import Chain

    manifest = _read_manifest(filepath)
    if samples is None:
        if manifest is None:
            raise ValueError(
                f"{filepath} has no manifest.json; pass samples=[...] "
                "(and optionally diagnostics=[...]) explicitly"
            )
        samples = manifest["samples"]
        if diagnostics is None:
            diagnostics = manifest["diagnostics"]
    diagnostics = diagnostics or []
    raw = read_chain_csv(filepath, list(samples) + list(diagnostics), filesuffix)
    return Chain(
        samples={k: raw[k] for k in samples},
        diagnostics={k: raw[k] for k in diagnostics},
        final_state=None,
    )


class ChainReader:
    """Incremental reader with mark/reset stream control — the reference's
    `mark(iostream)` / `reset(iostream)` fan-out over per-field streams
    (BasicContParamIOStream.jl:125-141).

    Useful for consuming a directory that a StreamingWriter is still
    appending to: ``read_new()`` returns only rows appended since the last
    call; ``mark()``/``reset()`` checkpoint and rewind the positions.
    """

    def __init__(self, filepath: str, fields=None, filesuffix: str = "csv"):
        self.filepath = filepath
        self.filesuffix = filesuffix
        if fields is None:
            manifest = _read_manifest(filepath)
            if manifest is not None:
                fields = list(manifest["samples"]) + list(manifest["diagnostics"])
            else:
                fields = [
                    f[: -len(f".{filesuffix}")]
                    for f in os.listdir(filepath)
                    if f.endswith(f".{filesuffix}")
                ]
        self.fields = list(fields)
        # binary mode: byte-exact tell/seek for the partial-line rewind
        self._handles = {
            name: open(os.path.join(filepath, f"{name}.{filesuffix}"), "rb")
            for name in self.fields
        }
        self._marks = {name: 0 for name in self.fields}
        # column counts (for shape-stable empty reads) from the manifest
        # when available, else learned from the first non-empty read
        self._ncols = {}
        manifest = _read_manifest(filepath)
        if manifest is not None:
            for name, shape in manifest.get("shapes", {}).items():
                if len(shape) >= 2:
                    self._ncols[name] = int(np.prod(shape[1:]))

    def mark(self):
        """Record current positions (reference `mark`, :125-132)."""
        self._marks = {name: h.tell() for name, h in self._handles.items()}

    def reset(self):
        """Rewind to the marked positions (reference `reset`, :134-141)."""
        for name, h in self._handles.items():
            h.seek(self._marks[name])

    def read_new(self) -> Dict[str, np.ndarray]:
        """Rows appended since the last read (or since mark+reset), as
        {field: (n_new_rows, n_cols) array}; fields with no new complete
        rows yield (0, n_cols) ((0, 0) when the width is not yet known).

        Safe against a concurrently-appending writer: only data up to the
        last newline is consumed — a partially-flushed trailing line is
        left in the file for the next read."""
        out = {}
        for name, h in self._handles.items():
            pos = h.tell()
            chunk = h.read()
            cut = chunk.rfind(b"\n") + 1  # consume complete lines only
            h.seek(pos + cut)
            lines = [
                ln for ln in chunk[:cut].decode().splitlines() if ln.strip()
            ]
            if lines:
                arr = np.asarray([[float(v) for v in ln.split(",")] for ln in lines])
                self._ncols.setdefault(name, arr.shape[1])
                out[name] = arr
            else:
                out[name] = np.zeros((0, self._ncols.get(name, 0)))
        return out

    def close(self):
        for h in self._handles.values():
            h.close()
        self._handles.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
