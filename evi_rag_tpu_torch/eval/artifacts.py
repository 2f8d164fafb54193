"""Stage hand-off artifact manifests.

The part of ``evi_rag_tpu/eval/artifacts.py`` the ``serve`` task needs: each
artifact ships a ``<split>.manifest.json`` with artifact / schema_version /
file, validated by consumers.
"""

from __future__ import annotations

import json
import pathlib
from datetime import datetime, timezone

SCHEMA_VERSION = 1


def write_manifest(
    dir_path: pathlib.Path, *, artifact: str, filename: str, split: str, extra: dict | None = None
) -> None:
    manifest = {
        "artifact": artifact,
        "schema_version": SCHEMA_VERSION,
        "file": filename,
        "split": split,
        "created_at": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "producer": "evi_rag_tpu_torch",
        **(extra or {}),
    }
    (pathlib.Path(dir_path) / f"{split}.manifest.json").write_text(json.dumps(manifest, indent=2))
