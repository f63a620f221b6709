"""Effective-dimension / Hessian-spectrum toolkit (Lanczos); counterpart
of `bnn_priors_tpu/eff_dim.py`, with the same names.

Used for the effective-dimensionality diagnostic N_eff(z) = Σ_i λ_i/(λ_i+z)
(Maddox et al., arXiv:2003.02139) of the Hessian of a loss at a posterior
sample. A loss is a function of a parameter dict; the Hessian is taken over
the flat packed parameter vector (`mcmc.packing.Packer`, PACK_ALIGN 1024),
as in the JAX package, whose padding tail carries no curvature.

Hessian-vector products are reverse-over-reverse: the gradient is taken
with `create_graph=True` and H·v is the gradient of g·v, which PyTorch
supports through every op of the models (cuDNN convolutions and batchnorm
included). `hessian_eigs_positive_lanczos` builds the gradient's graph once
and runs each of its Lanczos iterations' products as one pass back through
it. The Lanczos recursion is a plain loop of `num_iters` iterations with
full reorthogonalisation (two classical Gram–Schmidt passes against the
stored basis, (m, dim) matrix products) and no host synchronisation.

Where JAX takes a `key`, this module takes a `torch.Generator` on the
vector's device: the start vector cannot match JAX's draw, so two runs of
the packages agree on eigenvalues, not on Ritz vectors.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from .mcmc.packing import Packer

__all__ = ["unflatten_like", "hess_vec_prod", "hessian",
           "lanczos_tridiag", "symeig_positive_lanczos",
           "hessian_eigs_positive_lanczos", "effective_dimension"]


def unflatten_like(vec: torch.Tensor, tree: Dict[str, torch.Tensor]):
    "flat (total,) vector -> dict with the names and shapes of `tree`"
    pk = Packer(tree)
    if vec.shape[0] < pk.total_padded:
        vec = torch.cat([vec, vec.new_zeros(pk.total_padded - vec.shape[0])])
    return pk.unpack(vec)


def hess_vec_prod(loss_fn: Callable, params: Dict[str, torch.Tensor],
                  vec: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Hessian-vector product ∇²L(θ)·v, reverse-over-reverse.

    `loss_fn(params_dict) -> scalar`; `params`/`vec` are dicts of the same
    names and shapes. Returns the dict H·v."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    grads = torch.autograd.grad(loss_fn(dict(zip(names, leaves))), leaves,
                                create_graph=True, allow_unused=True,
                                materialize_grads=True)
    # a leaf the gradient does not depend on has no curvature: zeros
    gv = sum((g * vec[k]).sum() for k, g in zip(names, grads)
             if g.requires_grad)
    hv = torch.autograd.grad(gv, leaves, allow_unused=True,
                             materialize_grads=True)
    return dict(zip(names, hv))


def _packed_loss(loss_fn, packer):
    return lambda v: loss_fn(packer.unpack(v))


def hessian(loss_fn: Callable, params: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Dense (total, total) Hessian over the packed parameter vector.

    Small models only (a test and verification tool)."""
    pk = Packer(params)
    f = _packed_loss(loss_fn, pk)
    theta = pk.pack({k: v.detach() for k, v in params.items()})
    H = torch.autograd.functional.hessian(f, theta)
    n = pk.total
    return H[:n, :n]


def dataset_loss(model_loss: Callable, batches: Iterable) -> Callable:
    """Summed loss over an iterable of (x, y) batches, as one scalar fn of
    params (`model_loss(params, x, y)` a batch)."""
    batches = list(batches)

    def loss_fn(params):
        total = 0.0
        for x, y in batches:
            total = total + model_loss(params, x, y)
        return total
    return loss_fn


def lanczos_tridiag(matvec: Callable[[torch.Tensor], torch.Tensor],
                    dim: int, generator: Optional[torch.Generator],
                    num_iters: int, dtype=torch.float32, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos with full reorthogonalisation.

    Returns (T, Q): T is the (m, m) tridiagonal projection, Q the (m, dim)
    orthonormal basis, m = min(num_iters, dim). The start vector is a
    standard normal draw from `generator` (on `device`; a generator seeded
    0 there when None), normalised. Each iteration reorthogonalises with
    two classical Gram–Schmidt passes against the stored basis (rows past
    the current one are still zero and contribute nothing), and writes no
    row at the last iteration. A residual of norm at most 1e-10 gives a
    zero row."""
    m = min(num_iters, dim)
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    v0 = torch.randn(dim, generator=generator, dtype=dtype, device=device)
    v0 = v0 / torch.linalg.vector_norm(v0)

    Q = v0.new_zeros(m, dim)
    Q[0] = v0
    alphas = v0.new_zeros(m)
    betas = v0.new_zeros(m)
    v_prev = torch.zeros_like(v0)
    beta_prev = v0.new_zeros(())
    for i in range(m):
        v = Q[i]
        w = matvec(v)
        alpha = torch.dot(w, v)
        w = w - alpha * v - beta_prev * v_prev
        for _ in range(2):
            w = w - Q[:i + 1].T @ (Q[:i + 1] @ w)
        beta = torch.linalg.vector_norm(w)
        w = torch.where(beta > 1e-10, w / beta, torch.zeros_like(w))
        if i + 1 < m:
            Q[i + 1] = w
        alphas[i], betas[i] = alpha, beta
        v_prev, beta_prev = v, beta
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    return T, Q


def symeig_positive_lanczos(matvec_or_mat, dim: Optional[int] = None,
                            generator: Optional[torch.Generator] = None,
                            num_iters: int = 100, dtype=torch.float32,
                            device=None):
    """Ritz values and vectors via Lanczos, and which values are positive.

    Accepts a dense symmetric matrix or a matvec closure. Returns (evals
    ascending, Ritz vectors as the columns of a (dim, m) matrix, the mask
    evals > 1e-8), like `torch.linalg.eigh` restricted to the Krylov
    space."""
    if isinstance(matvec_or_mat, torch.Tensor) and matvec_or_mat.ndim == 2:
        A = matvec_or_mat
        dim = A.shape[0]
        matvec = lambda v: A @ v
        dtype, device = A.dtype, A.device
    else:
        matvec = matvec_or_mat
        assert dim is not None
    T, Q = lanczos_tridiag(matvec, dim, generator, num_iters, dtype=dtype,
                           device=device)
    evals, evecs = torch.linalg.eigh(T)
    ritz_vectors = Q.T @ evecs  # (dim, m)
    pos = evals > 1e-8
    return evals, ritz_vectors, pos


def hessian_eigs_positive_lanczos(loss_fn: Callable,
                                  params: Dict[str, torch.Tensor],
                                  generator: Optional[torch.Generator] = None,
                                  num_iters: int = 100):
    """Ritz values and vectors of the Hessian of `loss_fn` at `params`
    without materialising the Hessian. The loss's gradient graph is built
    once; every product is one pass back through it, its padding tail
    zeroed."""
    pk = Packer(params)
    f = _packed_loss(loss_fn, pk)
    theta = pk.pack({k: v.detach() for k, v in params.items()})
    theta.requires_grad_()
    g, = torch.autograd.grad(f(theta), theta, create_graph=True)

    def matvec(v):
        hv, = torch.autograd.grad(g, theta, v, retain_graph=True)
        return pk.mask_pad(hv)

    return symeig_positive_lanczos(
        matvec, dim=pk.total_padded, generator=generator,
        num_iters=num_iters, dtype=theta.dtype, device=theta.device)


def effective_dimension(eigenvalues: torch.Tensor, z: float) -> torch.Tensor:
    "N_eff(z) = Σ_i λ_i/(λ_i + z) over positive eigenvalues"
    lam = torch.clamp(eigenvalues, min=0.0)
    return torch.sum(lam / (lam + z))
