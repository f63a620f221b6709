"""Mixture priors and the string registry `get_prior` (counterpart of
`bnn_priors_tpu/priors/mixture.py`).

Components are sub-priors with no leaf of their own (`suppress`): each is
a child module `component_<i>`, and the mixture evaluates every
component's density at its own leaf. The `mixture_weights` leaf is a free
(flat-prior) parameter sampled by the MCMC kernel, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from .base import join
from . import fixed_cov
from .empirical_bayes import (ConvCorrNormalEmpirical, GenNormEmpirical,
                              LaplaceEmpirical, NormalEmpirical,
                              StudentTEmpirical, flat_positive)
from .hierarchical import (ConvCorrNormalGamma, GenNormUniform, Horseshoe,
                           LaplaceGamma, LaplaceUniform, NormalGamma,
                           NormalUniform, StudentTGamma, StudentTUniform)
from .loc_scale import (Cauchy, ConvCorrelatedNormal, GenNorm, Improper,
                        Laplace, LocScale, LogNormal, Normal, StudentT)
from .transformed import DoubleGamma, Uniform

__all__ = ("Mixture", "ScaleMixture", "ScaleMixtureEmpirical", "get_prior")


def get_prior(prior_name: str):
    priors = {
        "gaussian": Normal,
        "convcorrnormal": ConvCorrelatedNormal,
        "convcorrnormal_fitted_ls": ConvCorrelatedNormal,
        "convcorrnormal_empirical": ConvCorrNormalEmpirical,
        "convcorrnormal_gamma": ConvCorrNormalGamma,
        "datadrivencorrnormal": Normal,
        "datadrivencorrdoublegamma": DoubleGamma,
        "fixedcov_normal": fixed_cov.FixedCovNormal,
        "fixedcov_gennorm": fixed_cov.FixedCovGenNorm,
        "lognormal": LogNormal,
        "laplace": Laplace,
        "cauchy": Cauchy,
        "student-t": StudentT,
        "uniform": Uniform,
        "improper": Improper,
        "gaussian_gamma": NormalGamma,
        "gaussian_uniform": NormalUniform,
        "horseshoe": Horseshoe,
        "laplace_gamma": LaplaceGamma,
        "laplace_uniform": LaplaceUniform,
        "student-t_gamma": StudentTGamma,
        "student-t_uniform": StudentTUniform,
        "gennorm": GenNorm,
        "gennorm_uniform": GenNormUniform,
        "gaussian_empirical": NormalEmpirical,
        "laplace_empirical": LaplaceEmpirical,
        "student-t_empirical": StudentTEmpirical,
        "gennorm_empirical": GenNormEmpirical,
        "scale_mixture": ScaleMixture,
        "mixture": Mixture,
        "scale_mixture_empirical": ScaleMixtureEmpirical,
    }
    assert prior_name in priors, f"unknown prior {prior_name!r}"
    return priors[prior_name]


class Mixture(LocScale):
    """prob(p) = Σ_i softmax(w)_i · exp(comp_i.log_prob(p)); the mixture
    weights are the flat-prior leaf `mixture_weights`"""

    def __init__(self, shape, loc, scale, components="g_l_s_c_gn"):
        comp_names = self.get_components(components)
        assert len(comp_names) > 0, "Too few mixture components"
        super().__init__(shape, loc, scale)
        self._build_components(
            [get_prior(c)(shape, loc, scale) for c in comp_names])

    def _build_components(self, components):
        self.components = components
        for i, comp in enumerate(components):
            comp.suppress()
            self.add_module(f"component_{i}", comp)
            self.hypers[f"component_{i}"] = comp
        self.mixture_weights = nn.Parameter(torch.zeros(len(components)))

    def extra_leaf_shapes(self):
        return {"mixture_weights": (len(self.components),)}

    def _dist(self, **kwargs):
        raise NotImplementedError("Mixture has no single distribution")

    def log_prob_value(self, params, prefix, value):
        w = self.leaf(params, prefix, "mixture_weights")
        log_ps = torch.stack([
            comp.log_prob_value(params, join(prefix, f"component_{i}"), value)
            for i, comp in enumerate(self.components)], dim=-1)
        return (torch.logsumexp(w + log_ps, dim=-1)
                - torch.logsumexp(w, dim=-1))

    def _sample_p(self, generator, params, prefix):
        w = params.get(join(prefix, "mixture_weights"))
        if w is None:
            w = torch.zeros(len(self.components), dtype=torch.float64)
        idx = int(torch.multinomial(torch.softmax(w, -1), 1,
                                    generator=generator))
        return self.components[idx]._sample_p(
            generator, params, join(prefix, f"component_{idx}"))

    @staticmethod
    def get_components(comp_string: str):
        comp_dict = {
            "g": "gaussian", "ln": "lognormal", "l": "laplace", "c": "cauchy",
            "s": "student-t", "u": "uniform", "i": "improper",
            "gg": "gaussian_gamma", "gu": "gaussian_uniform", "h": "horseshoe",
            "lg": "laplace_gamma", "lu": "laplace_uniform",
            "sg": "student-t_gamma", "su": "student-t_uniform",
            "gn": "gennorm", "gnu": "gennorm_uniform",
            "ge": "gaussian_empirical", "le": "laplace_empirical",
            "se": "student-t_empirical", "gne": "gennorm_empirical",
        }
        abrvs = comp_string.split("_")
        assert all(a in comp_dict for a in abrvs), "Unknown mixture components"
        return [comp_dict[a] for a in abrvs]


class ScaleMixture(Mixture):
    "one base family at 5 geometric scales (reference mixture.py:130-150)"

    def __init__(self, shape, loc, scale, base_dist="gaussian", scales=None):
        if scales is None:
            scales = [scale / 9, scale / 3, scale, scale * 3, scale * 9]
        LocScale.__init__(self, shape, loc, scale)
        self.scales = list(scales)
        self._build_components(
            [get_prior(base_dist)(shape, loc, scl) for scl in self.scales])


class ScaleMixtureEmpirical(Mixture):
    "a scale mixture whose component scales are free (flat-prior) leaves"

    def __init__(self, shape, loc, scale, base_dist="gaussian", scales=None):
        if scales is None:
            scales = [scale / 9, scale / 3, scale, scale * 3, scale * 9]
        LocScale.__init__(self, shape, loc, scale)
        self.scales = list(scales)
        self._build_components([get_prior(base_dist)(shape, loc,
                                                     flat_positive(scl))
                                for scl in self.scales])
