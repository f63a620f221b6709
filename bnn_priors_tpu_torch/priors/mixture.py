"""The string registry `get_prior` (counterpart of
`bnn_priors_tpu/priors/mixture.py:34-36`). Only `gaussian` is ported; the
mixture priors themselves and the other names wait for a later slice."""
from __future__ import annotations

from .loc_scale import Normal


def get_prior(prior_name: str):
    priors = {"gaussian": Normal}
    if prior_name not in priors:
        raise NotImplementedError(
            f"prior {prior_name!r} is not ported yet (ported: {sorted(priors)})")
    return priors[prior_name]
