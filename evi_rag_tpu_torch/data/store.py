"""Flat-binary sample store: the reader half.

Copy of the reading side of ``evi_rag_tpu/data/store.py``: one ``data.bin``
of serialized records, an ``offsets.npy`` (int64 [N, 2] offset/length), an
``ids.json`` key table and a ``manifest.json`` validated on open.  Records
are dicts of numpy arrays / scalars / strings in a small self-describing
binary codec (no pickle).
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np

MANIFEST_NAME = "manifest.json"
_MAGIC = b"ERTS"  # EVI-RAG-TPU store record


def decode_record(raw: bytes | memoryview) -> dict[str, Any]:
    raw = memoryview(raw)
    if bytes(raw[:4]) != _MAGIC:
        raise ValueError("corrupt store record (bad magic)")
    hlen = int(np.frombuffer(raw[4:12], dtype=np.int64)[0])
    header = json.loads(bytes(raw[12 : 12 + hlen]))
    payload = raw[12 + hlen :]
    out: dict[str, Any] = {}
    for key, e in header.items():
        t = e["t"]
        if t == "nd":
            out[key] = np.frombuffer(
                payload[e["off"] : e["off"] + e["len"]], dtype=np.dtype(e["dtype"])
            ).reshape(e["shape"])
        elif t == "b":
            out[key] = bytes(payload[e["off"] : e["off"] + e["len"]])
        elif t == "s":
            out[key] = bytes(payload[e["off"] : e["off"] + e["len"]]).decode()
        elif t in ("i", "f", "bool"):
            out[key] = e["v"]
        else:
            raise ValueError(f"unknown store entry type {t!r}")
    return out


class SampleStore:
    """Memory-mapped random-access reader; safe for concurrent readers."""

    def __init__(
        self,
        path: str | pathlib.Path,
        *,
        expected_artifact: str | None = None,
        expected_schema_version: int | None = None,
    ) -> None:
        self.path = pathlib.Path(path).absolute()
        manifest_path = self.path / MANIFEST_NAME
        if not manifest_path.exists():
            raise FileNotFoundError(f"store manifest missing: {manifest_path}")
        self.manifest = json.loads(manifest_path.read_text())
        if expected_artifact is not None and self.manifest.get("artifact") != expected_artifact:
            raise ValueError(
                f"store artifact mismatch: {self.manifest.get('artifact')!r} != {expected_artifact!r}"
            )
        if (
            expected_schema_version is not None
            and int(self.manifest.get("schema_version", -1)) != expected_schema_version
        ):
            raise ValueError(
                f"store schema_version mismatch: {self.manifest.get('schema_version')} "
                f"!= {expected_schema_version}"
            )
        self.offsets = np.load(self.path / "offsets.npy")
        self.ids: list[str] = json.loads((self.path / "ids.json").read_text())
        if len(self.ids) != self.offsets.shape[0]:
            raise ValueError("store ids/offsets length mismatch")
        self._id_to_idx = {s: i for i, s in enumerate(self.ids)}
        self._mmap = np.memmap(self.path / "data.bin", dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return len(self.ids)

    def get(self, sample_id: str) -> dict[str, Any]:
        idx = self._id_to_idx.get(str(sample_id))
        if idx is None:
            raise KeyError(f"sample {sample_id!r} not in store {self.path}")
        return self.get_by_index(idx)

    def get_by_index(self, idx: int) -> dict[str, Any]:
        off, length = self.offsets[idx]
        return decode_record(self._mmap[off : off + length].tobytes())
