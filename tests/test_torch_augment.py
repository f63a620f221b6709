"""The port's CIFAR-10 augmentation (`bnn_priors_tpu_torch/data/cifar.py`)
against the JAX package's `random_crop_flip`: the crop and flip fed the JAX
function's own draws give its images exactly; the port's draws are uniform
offsets on 0..2·pad and fair flips; a seed replays its images and the
runners' per-step streams differ from step to step and chain to chain."""
import jax
import numpy as np
import pytest
import scipy.stats
import torch

from bnn_priors_tpu.data import cifar as jax_cifar
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import (FakeCIFAR10, crop_flip,
                                       draw_crop_flip, random_crop_flip)
from bnn_priors_tpu_torch.inference import SGLDRunner

from test_torch_models import torch_threads_per_worker  # noqa: F401


def jax_draws(key, B, pad):
    "random_crop_flip's split/randint/bernoulli on `key` (cifar.py:80-89)"
    k1, k2, k3 = jax.random.split(key, 3)
    dy = jax.random.randint(k1, (B,), 0, 2 * pad + 1)
    dx = jax.random.randint(k2, (B,), 0, 2 * pad + 1)
    flip = jax.random.bernoulli(k3, 0.5, (B,))
    return (torch.as_tensor(np.array(a)) for a in (dy, dx, flip))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pad", [4, 2])
def test_crop_flip_matches_jax(seed, pad):
    B = 64
    x = np.random.RandomState(seed).randn(B, 3, 32, 32).astype(np.float32)
    key = jax.random.key(seed)
    ref = np.asarray(jax_cifar.random_crop_flip(key, x, pad=pad))
    dy, dx, flip = jax_draws(key, B, pad)
    out = crop_flip(torch.as_tensor(x), dy, dx, flip, pad=pad)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_crop_flip_with_a_chain_axis():
    "a (K, B, C, H, W) batch: row k is the (B, ...) crop with row k's draws"
    K, B = 3, 16
    x = torch.as_tensor(np.random.RandomState(5).randn(K, B, 3, 32, 32))
    gens = [torch.Generator().manual_seed(10 + k) for k in range(K)]
    out = random_crop_flip(x, gens)
    for k in range(K):
        dy, dx, flip = draw_crop_flip((B,), torch.Generator().manual_seed(
            10 + k))
        torch.testing.assert_close(out[k], crop_flip(x[k], dy, dx, flip),
                                   rtol=0, atol=0)


def test_draws_are_uniform_and_independent():
    "χ² of the offsets on 0..8, and the joint (dy, dx, flip) table"
    n, pad = 180_000, 4
    dy, dx, flip = draw_crop_flip((n,), torch.Generator().manual_seed(0), pad)
    for t in (dy, dx):
        assert int(t.min()) == 0 and int(t.max()) == 2 * pad
        counts = np.bincount(t.numpy(), minlength=2 * pad + 1)
        assert scipy.stats.chisquare(counts).pvalue > 1e-3
    rate = float(flip.double().mean())
    assert abs(rate - 0.5) < 5 * 0.5 / np.sqrt(n)  # 5 standard errors
    cell = (dy * (2 * pad + 1) + dx) * 2 + flip.long()
    joint = np.bincount(cell.numpy(), minlength=2 * (2 * pad + 1) ** 2)
    assert scipy.stats.chisquare(joint).pvalue > 1e-3


def test_a_seed_replays_its_images():
    x = torch.as_tensor(np.random.RandomState(1).randn(32, 3, 32, 32))
    a = random_crop_flip(x, torch.Generator().manual_seed(7))
    b = random_crop_flip(x, torch.Generator().manual_seed(7))
    c = random_crop_flip(x, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a crop keeps the image's values, moved, or zero padding
    assert set(np.unique(a.numpy())) <= set(np.unique(x.numpy())) | {0.0}


def test_runner_streams_replay_by_seed_and_step():
    """a runner's augmentation at step t depends only on its seed and t: the
    same seed replays it, the next step and another seed do not"""
    data = FakeCIFAR10(n_train=32, n_test=4, device="cpu")
    x = data.norm.train[0][:16]

    def runner(seed):
        net = models.ResNet(depth=8)
        net.init(torch.Generator().manual_seed(0))
        return SGLDRunner(net, data.norm.train, None, 1, 0, 1,
                          augment_fn=FakeCIFAR10.augment_fn, seed=seed,
                          device="cpu")
    r1, r2, r3 = runner(0), runner(0), runner(1)
    s3 = r1._augment(x, 3)
    assert torch.equal(s3, r2._augment(x, 3))
    assert torch.equal(s3, r1._augment(x, 3))  # re-seeded, not advanced
    assert not torch.equal(s3, r1._augment(x, 4))
    assert not torch.equal(s3, r3._augment(x, 3))
