"""The port's export providers against the JAX package's (upload side of
training_operator_tpu/initializers/core.py).

Both packages import their back end when a provider is called, so the tests
put recording fakes of `huggingface_hub` and `boto3` in sys.modules and
hold the port's `export.upload` to the JAX `initializers.core.upload`: the
same calls with the same arguments, the credential resolved the same way.
Nothing reaches the network and nothing is installed.
"""

import sys
import types

import pytest

from training_operator_tpu.initializers import core as jax_core
from training_operator_tpu_torch import export
from training_operator_tpu_torch.trainer import standalone


@pytest.fixture
def calls(monkeypatch):
    """Installs the fakes; returns the list every fake call appends to."""
    record = []
    hub = types.ModuleType("huggingface_hub")

    class HfApi:
        def __init__(self, token=None):
            record.append(("HfApi", {"token": token}))

        def upload_folder(self, **kwargs):
            record.append(("upload_folder", kwargs))

    hub.HfApi = HfApi
    boto3 = types.ModuleType("boto3")

    class S3:
        def upload_file(self, *args, **kwargs):
            record.append(("upload_file", args, kwargs))

    def client(*args, **kwargs):
        record.append(("client", args, kwargs))
        return S3()

    boto3.client = client
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    monkeypatch.setitem(sys.modules, "boto3", boto3)
    return record


@pytest.fixture
def artifact(tmp_path):
    """A final-step directory with a nested one, as a checkpoint has."""
    root = tmp_path / "20"
    (root / "model" / "shards").mkdir(parents=True)
    (root / "metadata.json").write_text("{}")
    (root / "model" / "a.bin").write_bytes(b"a")
    (root / "model" / "shards" / "b.bin").write_bytes(b"bb")
    return str(root)


ENVS = [
    {"ACCESS_TOKEN": "tok"},
    {"SECRET_REF": "team-a.hf", "SECRET_TEAM_A_HF": "from-secret"},
    {"ACCESS_TOKEN": "tok", "SECRET_REF": "x", "SECRET_X": "not-this"},
    {"SECRET_REF": "missing"},
    {},
]


@pytest.mark.parametrize("environ", ENVS)
def test_access_token_resolves_as_from_env(environ):
    assert export.access_token(environ) == \
        jax_core.InitializerConfig.from_env(environ).access_token


def _both(local_dir, uri, environ, record):
    """(JAX calls, port calls) of one upload each, under `environ`."""
    assert jax_core.upload(local_dir, uri, jax_core.InitializerConfig.from_env(environ)) == uri
    jax_calls = list(record)
    record.clear()
    assert export.upload(local_dir, uri, environ) == uri
    return jax_calls, list(record)


@pytest.mark.parametrize("environ", ENVS[:2])
def test_hf_upload_makes_the_jax_providers_calls(calls, artifact, environ):
    jax_calls, port_calls = _both(artifact, "hf://org/model", environ, calls)
    assert port_calls == jax_calls
    assert port_calls == [("HfApi", {"token": export.access_token(environ)}),
                          ("upload_folder", {"repo_id": "org/model", "folder_path": artifact})]


@pytest.mark.parametrize("uri", ["s3://bucket/runs/job-1", "s3://bucket"])
def test_s3_upload_makes_the_jax_providers_calls(calls, artifact, uri):
    """Every file of the nested directory, keyed as the JAX provider keys
    it (the prefix joined to the path below the directory)."""
    jax_calls, port_calls = _both(artifact, uri, {}, calls)
    assert port_calls == jax_calls
    assert port_calls[0] == ("client", ("s3",), {})
    keys = sorted(c[1][2] for c in port_calls[1:])
    prefix = uri.partition("://")[2].partition("/")[2]
    want = ["metadata.json", "model/a.bin", "model/shards/b.bin"]
    assert keys == sorted(f"{prefix}/{k}" if prefix else k for k in want)
    assert {c[1][1] for c in port_calls[1:]} == {"bucket"}


@pytest.mark.parametrize("uri,package", [("hf://org/model", "huggingface_hub"),
                                         ("s3://bucket/p", "boto3")])
def test_a_missing_package_raises_naming_it(monkeypatch, artifact, uri, package):
    monkeypatch.setitem(sys.modules, package, None)  # import raises ImportError
    with pytest.raises(RuntimeError, match=package):
        export.upload(artifact, uri, {})
    with pytest.raises(RuntimeError, match=package):
        jax_core.upload(artifact, uri, jax_core.InitializerConfig())


def test_export_final_passes_its_environ_through(calls, tmp_path, artifact):
    """The trainer entry's export takes the credential from the environ it
    is given, not the process's."""
    environ = {"MODEL_EXPORT_URI": "hf://org/final", "SECRET_REF": "hub",
               "SECRET_HUB": "s3cret"}
    ckpt = str(tmp_path)  # holds step 20: the artifact
    assert standalone.export_final(ckpt, 20, environ) == "hf://org/final"
    assert calls == [("HfApi", {"token": "s3cret"}),
                     ("upload_folder", {"repo_id": "org/final", "folder_path": artifact})]
