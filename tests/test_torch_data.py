"""repro_torch.data against repro.data (CPU): ``TokenStream``,
``CifarLikeImages`` and ``host_shard_bounds`` equal the JAX package's bit
for bit over a grid of (seed, step, host, n_hosts), and twins of
``tests/test_data.py``'s properties hold on the port (the host-shard
partition over a fixed grid here: the hypothesis sweep is ``slow``)."""
import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data
from repro_torch.data import CifarLikeImages, TokenStream, host_shard_bounds

GRID = [(seed, step, host, n_hosts) for seed in (0, 3)
        for step in (0, 1, 999) for n_hosts in (1, 3) for host in
        range(n_hosts)]


@pytest.mark.parametrize("seed,step,host,n_hosts", GRID)
def test_token_stream_bitwise(seed, step, host, n_hosts):
    kw = dict(vocab=97, seq_len=16, global_batch=7, seed=seed)
    got = TokenStream(**kw).batch_at(step, host, n_hosts)
    want = jdata.TokenStream(**kw).batch_at(step, host, n_hosts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,step,host,n_hosts", GRID)
def test_cifar_like_bitwise(seed, step, host, n_hosts):
    got = CifarLikeImages(seed=seed).batch_at(step, 8, host, n_hosts)
    want = jdata.CifarLikeImages(seed=seed).batch_at(step, 8, host, n_hosts)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    lab = want["label"]
    for a, b in zip(CifarLikeImages(seed=seed).blob_center(lab),
                    jdata.CifarLikeImages(seed=seed).blob_center(lab)):
        np.testing.assert_array_equal(a, b)


def test_host_shard_bounds_equal():
    for gb in (1, 7, 8, 64, 511):
        for n in (1, 2, 3, 7, 64):
            for h in range(n):
                assert host_shard_bounds(gb, h, n) == \
                    jdata.host_shard_bounds(gb, h, n)


def test_exports():
    assert data.__all__ == jdata.__all__


# twins of tests/test_data.py

def test_batches_deterministic():
    ds = TokenStream(vocab=97, seq_len=16, global_batch=8, seed=3)
    a, b = ds.batch_at(5), ds.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], ds.batch_at(6)["tokens"])


def test_labels_are_shifted_tokens():
    b = TokenStream(vocab=97, seq_len=16, global_batch=4).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_markov_structure_learnable():
    b = TokenStream(vocab=53, seq_len=64, global_batch=16,
                    noise=0.05).batch_at(1)
    assert ((31 * b["tokens"] + 17) % 53 == b["labels"]).mean() > 0.85


@pytest.mark.parametrize("global_batch", [1, 5, 64, 512])
def test_host_shards_partition_batch(global_batch):
    for n_hosts in (1, 3, 7, 64):
        covered = []
        for h in range(n_hosts):
            lo, hi = host_shard_bounds(global_batch, h, n_hosts)
            covered.extend(range(lo, hi))
        assert covered == list(range(global_batch))


def test_per_host_batches_differ():
    ds = TokenStream(vocab=97, seq_len=8, global_batch=8)
    a = ds.batch_at(0, host_id=0, n_hosts=2)
    b = ds.batch_at(0, host_id=1, n_hosts=2)
    assert a["tokens"].shape == (4, 8)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_blob_images_class_conditional():
    ds = CifarLikeImages()
    b = ds.batch_at(0, batch=64)
    assert b["image"].shape == (64, 32, 32, 3)
    cy, cx = ds.blob_center(b["label"])
    vals = b["image"][np.arange(64), cy.astype(int), cx.astype(int), 2]
    assert vals.mean() > b["image"][..., 2].mean() + 0.5
