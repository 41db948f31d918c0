"""Model export: push a trained artifact directory to a storage URI.

The port's copy of the upload side of training_operator_tpu/initializers/
core.py: the scheme dispatch (`upload`), the credential resolution of
`InitializerConfig.from_env` (`access_token`) and the three providers.

- `file://<path>` and bare paths copy the directory's contents into `<path>`.
- `hf://<repo>` uploads the directory to a Hugging Face Hub repo through
  `huggingface_hub.HfApi(token=...).upload_folder`.
- `s3://<bucket>/<prefix>` uploads every file under the directory through
  `boto3.client("s3").upload_file`, keyed `<prefix>/<path relative to the
  directory>`.

The hub and S3 providers import their package when called and raise,
naming it, when it is missing. Every other scheme raises, naming it.
"""

from __future__ import annotations

import os
import shutil
from typing import Mapping, Optional


def access_token(environ: Mapping[str, str]) -> Optional[str]:
    """The export credential: an explicit ACCESS_TOKEN wins; else SECRET_REF
    (the operator's pointer into cluster secrets) resolves through
    SECRET_<REF> in the environment, every non-alphanumeric of the ref
    upper-cased to `_` (a Secret's name may hold `-` and `.`, an env
    variable's may not)."""
    token = environ.get("ACCESS_TOKEN") or None
    secret_ref = environ.get("SECRET_REF")
    if token is None and secret_ref:
        key = "SECRET_" + "".join(ch if ch.isalnum() else "_" for ch in secret_ref.upper())
        token = environ.get(key) or None
    return token


def _file_upload(local_dir: str, uri: str, environ: Mapping[str, str]) -> str:
    dest = uri.partition("://")[2] or uri
    os.makedirs(dest, exist_ok=True)
    shutil.copytree(local_dir, dest, dirs_exist_ok=True)
    return uri


def _hf_upload(local_dir: str, uri: str, environ: Mapping[str, str]) -> str:
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError("huggingface_hub is not installed; hf:// export unavailable") from e
    repo = uri.partition("://")[2]
    HfApi(token=access_token(environ)).upload_folder(repo_id=repo, folder_path=local_dir)
    return uri


def _s3_upload(local_dir: str, uri: str, environ: Mapping[str, str]) -> str:
    try:
        import boto3
    except ImportError as e:
        raise RuntimeError("boto3 is not installed; s3:// export unavailable") from e
    bucket, _, prefix = uri.partition("://")[2].partition("/")
    s3 = boto3.client("s3")
    for root, _dirs, files in os.walk(local_dir):
        for f in files:
            path = os.path.join(root, f)
            s3.upload_file(path, bucket, os.path.join(prefix, os.path.relpath(path, local_dir)))
    return uri


_PROVIDERS = {"file": _file_upload, "hf": _hf_upload, "s3": _s3_upload}


def upload(local_dir: str, uri: str, environ: Optional[Mapping[str, str]] = None) -> str:
    """Export `local_dir` to `uri`; returns the uri. `environ` (default
    os.environ) supplies the credential (`access_token`)."""
    scheme, sep, _ = uri.partition("://")
    if not sep:
        scheme = "file"
    provider = _PROVIDERS.get(scheme)
    if provider is None:
        raise ValueError(f"no export provider for scheme {scheme!r} (known: "
                         f"{sorted(_PROVIDERS)})")
    return provider(local_dir, uri, os.environ if environ is None else environ)
