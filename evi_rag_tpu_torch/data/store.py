"""Flat-binary sample store: writer and reader.

Copy of ``evi_rag_tpu/data/store.py``: one ``data.bin`` of serialized
records, an ``offsets.npy`` (int64 [N, 2] offset/length), an ``ids.json``
key table and a ``manifest.json`` validated on open.  Records are dicts of
numpy arrays / scalars / strings in a small self-describing binary codec (no
pickle); a record the port writes is byte for byte the record the JAX
package writes for the same values.  Writers build in ``<dir>.tmp`` and
rename it into place on ``finalize``.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import shutil
from datetime import datetime, timezone
from typing import Any, Iterator, Mapping

import numpy as np

MANIFEST_NAME = "manifest.json"
_MAGIC = b"ERTS"  # EVI-RAG-TPU store record


def _encode_value(buf: io.BytesIO, value: Any) -> dict[str, Any]:
    """Append one value's payload to buf; return its index entry."""
    if isinstance(value, np.ndarray):
        start = buf.tell()
        data = np.ascontiguousarray(value)
        buf.write(data.tobytes())
        return {
            "t": "nd",
            "dtype": str(data.dtype),
            "shape": list(data.shape),
            "off": start,
            "len": buf.tell() - start,
        }
    if isinstance(value, (bytes, bytearray)):
        start = buf.tell()
        buf.write(bytes(value))
        return {"t": "b", "off": start, "len": buf.tell() - start}
    if isinstance(value, str):
        start = buf.tell()
        raw = value.encode()
        buf.write(raw)
        return {"t": "s", "off": start, "len": len(raw)}
    if isinstance(value, bool):
        return {"t": "bool", "v": bool(value)}
    if isinstance(value, (int, np.integer)):
        return {"t": "i", "v": int(value)}
    if isinstance(value, (float, np.floating)):
        return {"t": "f", "v": float(value)}
    if isinstance(value, (list, tuple)):
        arr = np.asarray(value)
        if arr.dtype == object:
            raise TypeError(f"unsupported list payload: {value!r}")
        return _encode_value(buf, arr)
    raise TypeError(f"unsupported store value type: {type(value).__name__}")


def encode_record(record: Mapping[str, Any]) -> bytes:
    buf = io.BytesIO()
    entries = {k: _encode_value(buf, v) for k, v in record.items()}
    payload = buf.getvalue()
    header = json.dumps(entries).encode()
    out = io.BytesIO()
    out.write(_MAGIC)
    out.write(np.int64(len(header)).tobytes())
    out.write(header)
    out.write(payload)
    return out.getvalue()


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


class SampleStoreWriter:
    """Append-only writer with atomic tmp-dir finalize."""

    def __init__(self, path: str | pathlib.Path) -> None:
        self.final_path = pathlib.Path(path).absolute()
        self.tmp_path = self.final_path.with_name(self.final_path.name + ".tmp")
        if self.tmp_path.exists():
            shutil.rmtree(self.tmp_path)
        self.tmp_path.mkdir(parents=True)
        self._data = (self.tmp_path / "data.bin").open("wb")
        self._ids: list[str] = []
        self._offsets: list[tuple[int, int]] = []
        self._finalized = False

    def add(self, sample_id: str, record: Mapping[str, Any]) -> None:
        if self._finalized:
            raise RuntimeError("writer already finalized")
        raw = encode_record(record)
        start = self._data.tell()
        self._data.write(raw)
        self._ids.append(str(sample_id))
        self._offsets.append((start, len(raw)))

    def finalize(self, *, artifact: str, schema_version: int = 1, extra: dict | None = None) -> pathlib.Path:
        if self._finalized:
            raise RuntimeError("writer already finalized")
        self._data.close()
        np.save(self.tmp_path / "offsets.npy", np.asarray(self._offsets, dtype=np.int64))
        (self.tmp_path / "ids.json").write_text(json.dumps(self._ids))
        manifest = {
            "artifact": artifact,
            "schema_version": int(schema_version),
            "file": "data.bin",
            "num_samples": len(self._ids),
            "created_at": datetime.now(timezone.utc).isoformat(timespec="seconds"),
            "producer": "evi_rag_tpu_torch.data.store",
            **(extra or {}),
        }
        (self.tmp_path / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
        if self.final_path.exists():
            shutil.rmtree(self.final_path)
        os.replace(self.tmp_path, self.final_path)
        self._finalized = True
        return self.final_path

    def abort(self) -> None:
        if not self._finalized:
            self._data.close()
            shutil.rmtree(self.tmp_path, ignore_errors=True)


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

    def __contains__(self, sample_id: str) -> bool:
        return sample_id in self._id_to_idx

    def get(self, sample_id: str) -> dict[str, Any]:
        idx = self._id_to_idx.get(str(sample_id))
        if idx is None:
            raise KeyError(f"sample {sample_id!r} not in store {self.path}")
        return self.get_by_index(idx)

    def get_by_index(self, idx: int) -> dict[str, Any]:
        off, length = self.offsets[idx]
        return decode_record(self._mmap[off : off + length].tobytes())

    def iter_records(self) -> Iterator[tuple[str, dict[str, Any]]]:
        for i, sid in enumerate(self.ids):
            yield sid, self.get_by_index(i)
