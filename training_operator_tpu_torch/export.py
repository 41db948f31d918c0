"""Model export: push a trained artifact directory to a storage URI.

The port's minimal copy of the scheme dispatch in
training_operator_tpu/initializers/core.py (`upload`, `get_provider`), with
the `file://` provider only: `file://<path>` and bare paths copy the
directory's contents into `<path>`. Every other scheme raises, naming it
(`hf://` and `s3://` need the network and are not ported yet).
"""

from __future__ import annotations

import os
import shutil


def _file_upload(local_dir: str, uri: str) -> str:
    dest = uri.partition("://")[2] or uri
    os.makedirs(dest, exist_ok=True)
    shutil.copytree(local_dir, dest, dirs_exist_ok=True)
    return uri


_PROVIDERS = {"file": _file_upload}


def upload(local_dir: str, uri: str) -> str:
    """Export `local_dir` to `uri`; returns the uri."""
    scheme, sep, _ = uri.partition("://")
    if not sep:
        scheme = "file"
    provider = _PROVIDERS.get(scheme)
    if provider is None:
        raise ValueError(f"no export provider for scheme {scheme!r} (ported: "
                         f"{sorted(_PROVIDERS)})")
    return provider(local_dir, uri)
