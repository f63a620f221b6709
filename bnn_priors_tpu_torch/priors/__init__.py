"Weight priors as nn.Modules (counterpart of `bnn_priors_tpu/priors`)."
from .base import (ParamStore, Prior, default_dtype, join, named_priors,
                   value_or_call)
from .loc_scale import (Cauchy, ConvCorrelatedNormal, GenNorm, Improper,
                        Laplace, LocScale, LogNormal, Normal,
                        PositiveImproper, StudentT)
from .transformed import DoubleGamma, Gamma, HalfCauchy, Uniform
from .hierarchical import (ConvCorrNormalGamma, GenNormUniform, Horseshoe,
                           LaplaceGamma, LaplaceUniform, NormalGamma,
                           NormalUniform, StudentTGamma, StudentTUniform)
from .empirical_bayes import (ConvCorrNormalEmpirical, GenNormEmpirical,
                              LaplaceEmpirical, NormalEmpirical,
                              StudentTEmpirical)
from .fixed_cov import (ConvCovariance, FixedCovDoubleGamma, FixedCovGenNorm,
                        FixedCovLaplace, FixedCovNormal)
from .multivariate_t import MultivariateT
from .mixture import Mixture, ScaleMixture, ScaleMixtureEmpirical, get_prior
