"""The port's data loader against the JAX package's: same rows, same
shuffle, same batches, and the same per-process split."""

import numpy as np
import pytest
import torch

from training_operator_tpu.trainer import data as jax_data
from training_operator_tpu_torch.trainer import data as pt_data


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_yields_the_jax_batches(shuffle):
    jds = jax_data.TokenDataset.synthetic(vocab_size=100, seq_len=16, num_rows=37, seed=3)
    pds = pt_data.TokenDataset.synthetic(vocab_size=100, seq_len=16, num_rows=37, seed=3)
    np.testing.assert_array_equal(jds.rows, pds.rows)
    jl = jax_data.DataLoader(jds, batch_size=5, shuffle=shuffle, seed=7, use_native=False)
    pl = pt_data.DataLoader(pds, batch_size=5, shuffle=shuffle, seed=7, device="cpu")
    for epoch in range(2):
        jb, pb = list(jl.epoch(epoch)), list(pl.epoch(epoch))
        assert len(jb) == len(pb) == 7
        for a, b in zip(jb, pb):
            assert set(a) == set(b) == {"tokens", "targets", "mask"}
            for key in a:
                assert b[key].device.type == "cpu"
                np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]))
            assert b["tokens"].dtype == torch.int32 and b["mask"].dtype == torch.float32


def test_process_shard_split_matches():
    rows = np.arange(10 * 5, dtype=np.int32).reshape(10, 5)
    env = {"PROCESS_ID": "2", "NUM_PROCESSES": "3"}
    assert pt_data.process_shard(env) == jax_data.process_shard(env) == (2, 3)
    assert pt_data.process_shard({}) == (0, 1)
    for pid in range(3):
        np.testing.assert_array_equal(
            pt_data.TokenDataset(rows, pid, 3).rows, jax_data.TokenDataset(rows, pid, 3).rows
        )


def test_pack_tokens_and_token_file(tmp_path):
    stream = np.arange(40, dtype=np.int32)
    np.testing.assert_array_equal(pt_data.pack_tokens(stream, 8), jax_data.pack_tokens(stream, 8))
    path = tmp_path / "tokens.bin"
    stream.tofile(path)
    np.testing.assert_array_equal(
        pt_data.TokenDataset.from_token_file(str(path), 8).rows,
        jax_data.TokenDataset.from_token_file(str(path), 8).rows,
    )


def test_drop_last_false_keeps_the_tail_and_prefetch_preserves_order():
    ds = pt_data.TokenDataset.synthetic(vocab_size=50, seq_len=4, num_rows=11)
    loader = pt_data.DataLoader(ds, batch_size=4, shuffle=False, drop_last=False, device="cpu")
    sizes = [b["tokens"].shape[0] for b in pt_data.prefetch(loader.epoch(0), 2)]
    assert sizes == [4, 4, 3]
    direct = [b["tokens"] for b in loader.epoch(0)]
    ahead = [b["tokens"] for b in pt_data.prefetch(loader.epoch(0), 3)]
    assert all(torch.equal(a, b) for a, b in zip(direct, ahead))


def test_batch_larger_than_shard_raises():
    ds = pt_data.TokenDataset.synthetic(vocab_size=50, seq_len=4, num_rows=3)
    with pytest.raises(ValueError):
        pt_data.DataLoader(ds, batch_size=4, device="cpu")
