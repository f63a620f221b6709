"""The chain axis and checkpoints with segmented and hybrid states: the
port's `MultiChainRunnerReject` with K=3 and `packing="segmented"` or
`"hybrid"` against the JAX package's of the same packing, step for step in
f64 at temperature 0 (rtol 1e-8) on test_torch_segmented_runners.py's
prior-only Gaussian model; the port's K=3 hybrid chains against its flat
chains at per-chain temperatures up to 1 (ResNet-8, positions to 1e-12);
and a hybrid or segmented run, one chain and K=3, stopped and resumed from
its checkpoint, bit for bit. (A file of its own, so that pytest-xdist's
`--dist loadfile` runs it beside the single-chain comparisons.)
"""
import copy

import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch import mcmc
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_segmented_runners import (CHAINS, ATOL, K, RESNET_RUN,  # noqa: F401
                                          RTOL, RUNS, XY, _init, jax_runs,
                                          port_model, resnet8)


@pytest.mark.parametrize("packing", ["segmented", "hybrid"])
def test_chain_runner_matches_jax_packing(packing, jax_runs):
    jr, _ = jax_runs("chains", packing)
    x, y = XY
    tr = MultiChainRunnerReject(
        port_model(), (torch.as_tensor(x), torch.as_tensor(y)), seed=9,
        device="cpu", packing=packing,
        init_params_fn=lambda c, g: {k: torch.as_tensor(v)
                                     for k, v in _init(c).items()},
        **CHAINS)
    assert isinstance(tr.chains.position, mcmc.SegVec)
    assert tr.chains.position.lead == (K,)
    tr.run()
    for a, b in zip(tr.chains.position.leaves, jr.states.position.leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for a, b in zip(tr.chains.precond.leaves, jr.states.precond.leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(np.stack(tr.rejections),
                                  np.stack(jr.rejections))
    np.testing.assert_allclose(np.stack(tr.delta_energies),
                               np.stack(jr.delta_energies), rtol=RTOL,
                               atol=ATOL)
    ts = tr.get_samples()
    js = jr.get_samples()
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_hybrid_chains_are_the_flat_chains(resnet8):
    "T in (0.5, 1, 0), K=3: each chain's hybrid run is its flat run"
    data, model = resnet8
    out = {}
    for packing in ("flat", "hybrid"):
        r = MultiChainRunnerReject(
            copy.deepcopy(model), data.norm.train, K,
            temperatures=[0.5, 1.0, 0.0], learning_rate=1e-3, momentum=0.9,
            batch_size=32, cycles=1, epochs_per_cycle=2, warmup_epochs=1,
            sample_epochs=1, precond_update=1, seed=4, device="cpu",
            packing=packing,
            init_params_fn=lambda i, g: he_initialize(copy.deepcopy(model),
                                                      g).params())
        r.run()
        out[packing] = (r.kernel.params_of(r.chains), r.rejections,
                        r.delta_energies)
    (fp, frej, fde), (hp, hrej, hde) = out["flat"], out["hybrid"]
    np.testing.assert_array_equal(np.stack(hrej), np.stack(frej))
    np.testing.assert_allclose(np.stack(hde), np.stack(fde), rtol=1e-10)
    for k, v in fp.items():
        np.testing.assert_allclose(hp[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("packing", ["segmented", "hybrid"])
def test_resume_is_bitwise_in_every_packing(packing, tmp_path):
    """T=1, one chain and K=3: a run stopped after its first cycle and
    resumed by a fresh runner of another seed ends bit for bit where the
    uninterrupted run ends; the file names each segment by its packing"""
    x, y = XY
    data = (torch.as_tensor(x), torch.as_tensor(y))
    run = dict(RUNS["reject"], temperature=1.0, cycles=2)

    def single(seed, **kw):
        model = port_model()
        with torch.no_grad():
            for k, v in _init(0).items():
                model.get_parameter(k).copy_(torch.as_tensor(v))
        return VerletSGLDRunnerReject(model, data, None, device="cpu",
                                      packing=packing, seed=seed, **run, **kw)

    def chains(seed):
        return MultiChainRunnerReject(
            port_model(), data, seed=seed, device="cpu", packing=packing,
            init_params_fn=lambda c, g: {k: torch.as_tensor(v)
                                         for k, v in _init(c).items()},
            **dict(CHAINS, temperatures=[0.5, 1.0, 1.0]))

    path = str(tmp_path / "chain.ckpt.npz")
    full = single(42)
    full.run()
    half = single(42, checkpoint_path=path, checkpoint_every=3)
    half.cycles = 1
    half.run()
    with np.load(path) as f:
        seg = [k for k in f.files if k.startswith("chain.position.")]
    assert len(seg) == full.kernel.packer.n_segments
    assert all(k.startswith(f"chain.position.{packing}.") for k in seg)
    resumed = single(7)
    resumed.run(resume_from=path)
    for name in ("position", "momentum", "grads", "square_avg", "precond"):
        for a, b in zip(getattr(full.chain, name).leaves,
                        getattr(resumed.chain, name).leaves):
            assert torch.equal(a, b), name
    assert (full.chain.key, full.chain.n_updates) == (
        resumed.chain.key, resumed.chain.n_updates)
    n = len(resumed.boundaries)  # the second cycle's boundaries
    assert n == 2 and full.boundaries[-n:] == resumed.boundaries

    path = str(tmp_path / "chains.ckpt.npz")
    full = chains(5)
    full.run()
    half = chains(5)
    half.cycles = 1
    half.run(checkpoint_path=path, checkpoint_every=2)
    resumed = chains(8)
    resumed.run(resume_from=path)
    for a, b in zip(full.chains.position.leaves,
                    resumed.chains.position.leaves):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.stack(full.rejections),
                                  np.stack(resumed.rejections))
    np.testing.assert_array_equal(np.stack(full.delta_energies),
                                  np.stack(resumed.delta_energies))
