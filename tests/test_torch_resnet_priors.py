"""Every registry prior that builds on the ResNet-20 models (29 of the 31
names; the other two need a parameter no ResNet-20 passes), as the port's
CLI builds them (`train_bnn.model_of`), beside the JAX CLI's models: the
same prior leaves with the same shapes and the same log prior in float64
at the same parameters, for `googleresnet` (the prior on the dense layer)
and `correlatedgoogleresnet` (the prior on the convolutions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch.experiments import train_bnn

from test_torch_cli_priors import jax_model
from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_priors import NAMES

ON_RESNET20 = tuple(n for n in NAMES if n not in
                    ("datadrivencorrdoublegamma", "fixedcov_gennorm"))


def test_twenty_nine_names():
    assert len(ON_RESNET20) == 29


@pytest.mark.parametrize("model", ["googleresnet", "correlatedgoogleresnet"])
@pytest.mark.parametrize("name", ON_RESNET20)
def test_resnet20_prior_matches_jax(model, name):
    cfg = dict(train_bnn.DEFAULTS, model=model, weight_prior=name)
    tm = train_bnn.model_of(cfg, "cpu", seed=1).double()
    jm = jax_model(model, name)
    jleaves = {}
    for prefix, prior in jm.named_priors():
        jleaves.update(prior.leaf_shapes(prefix))
    tleaves = {k: tuple(v.shape) for k, v in tm.params().items()
               if "_prior." in k}
    assert tleaves == jleaves
    params = {k: v.detach().numpy() for k, v in tm.params().items()}
    jlp = float(jm.log_prior({k: jnp.asarray(v) for k, v in params.items()}))
    tlp = float(tm.log_prior().detach())
    assert np.isfinite(tlp)
    np.testing.assert_allclose(tlp, jlp, rtol=1e-9)
