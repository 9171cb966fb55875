"""The port's data pipelines against the JAX package's, on the CPU.

The numpy parts (synthetic CIFAR and Titanic, ``prepare_rows``,
``split_data``, ``shard_dataset``, the skewed partitioners, the epoch
batcher) must give equal arrays.  ``normalize`` must give equal float32
values.  ``augment_batch`` is held bit for bit against the JAX package's:
the test derives the crop offsets and flip bits from the JAX key the same
way ``distributed_learning_tpu/data/cifar.py`` does and passes them in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu import data as jdata
from distributed_learning_tpu_torch import data as tdata


def _eq_shards(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k][0])
        np.testing.assert_array_equal(a[k][1], b[k][1])


def test_synthetic_cifar_and_normalize_equal_the_jax_package():
    for dataset in ("cifar10", "cifar100"):
        (xj, yj), (xtj, ytj) = jdata.synthetic_cifar(dataset, n_train=64, n_test=16, seed=3)
        (xt, yt), (xtt, ytt) = tdata.synthetic_cifar(dataset, n_train=64, n_test=16, seed=3)
        for a, b in ((xj, xt), (yj, yt), (xtj, xtt), (ytj, ytt)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tdata.normalize(xt, dataset).numpy(), np.asarray(jdata.normalize(jnp.asarray(xj), dataset)))
        np.testing.assert_array_equal(
            tdata.normalized_pad_value(dataset), jdata.normalized_pad_value(dataset))
    assert tdata.load_cifar()[0][0].shape == jdata.load_cifar()[0][0].shape


@pytest.mark.parametrize("pad", ["scalar", "per_channel"])
def test_augment_batch_is_bit_exact_against_jax(pad):
    (x, _), _ = jdata.synthetic_cifar(n_train=32, n_test=1, seed=0)
    xn = np.asarray(jdata.normalize(jnp.asarray(x)))
    pad_value = 0.25 if pad == "scalar" else jdata.normalized_pad_value()
    key = jax.random.key(11)
    want = np.asarray(jdata.augment_batch(key, jnp.asarray(xn), pad_value=pad_value))
    # The draws augment_batch makes inside (cifar.py: split, randint, bernoulli).
    k_crop, k_flip = jax.random.split(key)
    offs = np.asarray(jax.random.randint(k_crop, (32, 2), 0, 9))
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (32,)))
    assert flips.any() and not flips.all() and offs.min() == 0 and offs.max() == 8
    got = tdata.augment_batch(torch.tensor(xn), torch.tensor(offs), torch.tensor(flips),
                              pad_value=pad_value)
    np.testing.assert_array_equal(got.numpy(), want)


def test_draw_augment_is_seeded_and_in_range():
    g = torch.Generator().manual_seed(4)
    offs, flips = tdata.draw_augment(g, 512)
    assert offs.shape == (512, 2) and flips.shape == (512,) and flips.dtype == torch.bool
    assert int(offs.min()) == 0 and int(offs.max()) == 8
    assert 0.4 < flips.float().mean().item() < 0.6
    g.manual_seed(4)
    offs2, flips2 = tdata.draw_augment(g, 512)
    assert torch.equal(offs, offs2) and torch.equal(flips, flips2)


def test_titanic_pipeline_equals_the_jax_package():
    for a, b in zip(jdata.synthetic_titanic(n=300, seed=5), tdata.synthetic_titanic(n=300, seed=5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jdata.load_titanic(), tdata.load_titanic()):
        np.testing.assert_array_equal(a, b)
    assert tdata.titanic_source() == jdata.titanic_source()
    assert tdata.FEATURES == jdata.FEATURES
    rows = [
        {"Survived": "1", "Pclass": "3", "Sex": "male", "Age": "22", "SibSp": "1",
         "Parch": "0", "Fare": "7.25"},
        {"Survived": "", "Pclass": "1", "Sex": "female", "Age": "", "SibSp": "0",
         "Parch": "2", "Fare": "71.3"},
        {"Survived": "0", "Pclass": "2", "Sex": "female", "Age": "", "SibSp": "0",
         "Parch": "0", "Fare": ""},
    ]
    for a, b in zip(jdata.prepare_rows(rows), tdata.prepare_rows(rows)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("agents", [5, ["Alice", "Bob", "Charlie"]])
def test_split_and_shard_equal_the_jax_package(agents):
    X, y = tdata.synthetic_titanic(n=802, seed=1)
    _eq_shards(jdata.split_data(X, y, agents), tdata.split_data(X, y, agents))
    (xc, yc), _ = tdata.synthetic_cifar(n_train=200, n_test=1)
    _eq_shards(jdata.shard_dataset(xc, yc, agents, batch_size=16, seed=2),
               tdata.shard_dataset(xc, yc, agents, batch_size=16, seed=2))


def test_skewed_partitions_equal_the_jax_package():
    (X, y), _ = tdata.synthetic_cifar(n_train=600, n_test=1, seed=4)
    for kw in (dict(alpha=0.3, seed=7), dict(alpha=5.0, seed=1, batch_size=8)):
        _eq_shards(jdata.label_skew_shards(X, y, ["A", "B", "C"], **kw),
                   tdata.label_skew_shards(X, y, ["A", "B", "C"], **kw))
    for kw in (dict(ratio=2.0, seed=3), dict(ratio=1.0, seed=0, batch_size=16)):
        _eq_shards(jdata.size_skew_shards(X, y, 4, **kw), tdata.size_skew_shards(X, y, 4, **kw))
    with pytest.raises(ValueError, match="alpha must be > 0"):
        tdata.label_skew_shards(X, y, 2, alpha=0.0)


def test_epoch_batches_and_prefetch_on_the_cpu():
    X = np.arange(50, dtype=np.float32).reshape(25, 2)
    y = np.arange(25)
    want = list(jdata.epoch_batches(X, y, 4, seed=9))
    got = list(tdata.epoch_batches(X, y, 4, seed=9))
    assert len(got) == len(want) == 6
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    staged = list(tdata.prefetch_to_device(tdata.epoch_batches(X, y, 4, seed=9), device="cpu"))
    for (a, b), (c, d) in zip(staged, want):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(b.numpy(), d)
    staged = next(iter(tdata.prefetch_to_device(iter([{"x": X, "pair": (y, y)}]), device="cpu")))
    assert set(staged) == {"x", "pair"} and isinstance(staged["pair"], tuple)


def test_prefetch_propagates_source_errors_and_needs_the_card_by_default():
    def source():
        yield np.zeros(2), np.zeros(2)
        raise RuntimeError("boom")

    it = tdata.prefetch_to_device(source(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(tdata.prefetch_to_device(source()))
