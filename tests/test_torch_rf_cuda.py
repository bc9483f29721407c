"""The random forest on the card against the port on the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package (the CPU tests hold the port to
it), so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_rf_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from firebird_tpu_torch.ccd import cuda_ops
from firebird_tpu_torch.rf import forest, prng


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda

FIELDS = ("feature", "threshold", "leaf_proba", "classes")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the forest's card path runs only "
                    "there")
    return torch.device("cuda")


def test_draws_on_the_card_equal_the_cpu(dev):
    for seed in (0, 7, 2**31 - 1):
        keys = {d: forest.tree_keys(seed, range(16), d) for d in ("cpu", dev)}
        assert torch.equal(keys[dev].cpu(), keys["cpu"])
        for fn in (lambda k: prng.split(k, 3),
                   lambda k: prng.fold_in(k, 123),
                   lambda k: prng.random_bits(k, (4, 33)),
                   lambda k: prng.uniform(k, (128, 33))):
            assert torch.equal(fn(keys[dev]).cpu(), fn(keys["cpu"]))
        w = {d: forest.bootstrap_weights(keys[d], 5000) for d in keys}
        assert torch.equal(w[dev].cpu(), w["cpu"])


def _data(n, f, classes, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    X = rng.normal(0, 5, (classes, f))[y] + rng.normal(0, 1.0, (n, f))
    X = X.astype(np.float32)
    X[5, 1] = np.nan
    return X, y + 1


@pytest.mark.parametrize("n,f,classes,kw", [
    (1500, 6, 3, dict(n_trees=24, max_depth=6, n_bins=32, seed=1)),
    (2000, 33, 8, dict(n_trees=20, max_depth=8, n_bins=64, seed=4)),
])
def test_train_on_the_card_equals_the_cpu(dev, n, f, classes, kw):
    X, y = _data(n, f, classes, seed=n)
    cuda_ops.reset_launches()
    card = forest.train(X, y, device=dev, trees_per_chunk=64, **kw)
    assert not any(cuda_ops.LAUNCHES.values())
    host = forest.train(X, y, device="cpu", **kw)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(card, name), getattr(host, name))


def test_raw_predict_on_the_card_equals_the_cpu(dev):
    X, y = _data(1200, 33, 5, seed=2)
    m = forest.train(X, y, n_trees=40, device="cpu")
    Xq = np.concatenate([X, np.full((2, 33), np.nan, np.float32)])
    host = m.raw_predict(Xq, dense=False, device="cpu")
    dense = m.raw_predict(Xq, batch=700, device=dev)
    walk = m.raw_predict(Xq, dense=False, device=dev)
    # One order of addition everywhere: the card's forms equal each other
    # and the CPU's bit for bit.
    np.testing.assert_array_equal(dense, walk)
    np.testing.assert_array_equal(dense, host)
    np.testing.assert_allclose(dense[-1], m.leaf_proba[:, 0].sum(0),
                               rtol=1e-6)
