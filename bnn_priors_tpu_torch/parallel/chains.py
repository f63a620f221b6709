"""Initial states of K independent chains (counterpart of
`bnn_priors_tpu/parallel/chains.py:54-77`; the device mesh and
`ChainMesh` are not ported).

Every chain gets its own explicit generators: one for its initial
parameters and, through its chain seed, its own noise and M-H streams
(`VerletSGLDChains.init`). The chain state is a `(K, T)` bank, so the K
chains step together on one card.
"""
from __future__ import annotations

import copy

import torch


def init_chains_from_fn(kernel, n_chains: int, params_fn, seed: int = 0,
                        init_kwargs=None):
    """Stacked chain state with explicit per-chain initial parameters:
    `params_fn(chain_index, generator) -> params dict` (he-initialization,
    warm starts, ...), given a CPU generator of its own a chain; each chain
    also gets its own seed for its kernel streams. `seed` draws both."""
    gen = torch.Generator().manual_seed(int(seed))
    draw = lambda: int(torch.randint(0, 2 ** 62, (), generator=gen))
    per_chain, chain_seeds = [], []
    for i in range(n_chains):
        param_seed, chain_seed = draw(), draw()
        params = params_fn(i, torch.Generator().manual_seed(param_seed))
        per_chain.append({k: v.detach() for k, v in params.items()})
        chain_seeds.append(chain_seed)
    stacked = {k: torch.stack([p[k] for p in per_chain])
               for k in per_chain[0]}
    return kernel.init(stacked, chain_seeds, **(init_kwargs or {}))


def init_chains_diverse(kernel, model, n_chains: int, seed: int = 0,
                        init_kwargs=None):
    """an independent prior draw per chain (the ensemble workload's init);
    `model` itself is left as it is"""
    def params_fn(i, generator):
        return copy.deepcopy(model).init(generator).params()
    return init_chains_from_fn(kernel, n_chains, params_fn, seed, init_kwargs)
