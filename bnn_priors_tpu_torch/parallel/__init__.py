"The chain axis: K independent chains stepping together on one card."
from .chains import init_chains_diverse, init_chains_from_fn
from .multichain import MultiChainRunner, MultiChainRunnerReject

__all__ = ("init_chains_diverse", "init_chains_from_fn", "MultiChainRunner",
           "MultiChainRunnerReject")
