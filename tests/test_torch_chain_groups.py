"""Dispatch groups on the chain axis (test_torch_chain_inferences.py has
the runners and their helpers): a bank split into groups of chains gives
the ungrouped run bit for bit in f64."""
import numpy as np
import pytest
import torch

from test_torch_chain_inferences import _port_runner
from test_torch_models import torch_threads_per_worker  # noqa: F401


@pytest.fixture
def one_thread():
    """torch on one thread, as under xdist: its threaded CPU reductions
    split a chain's row among the threads by the number of rows, so a sum's
    order would depend on a dispatch group's size"""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,sizes", [("SGLD", (2, 1)),
                                        ("HMCReject", (2,))],
                         ids=["SGLD", "HMCReject"])
def test_grouped_equals_ungrouped(one_thread, name, sizes):
    """dispatch groups (of 2 and of 1 chain) give the ungrouped run bit for
    bit in f64 (entries, bank, momenta, batchnorm state, ΔE): chains are
    independent and every update stays one launch over the bank
    (tests/test_dispatch_groups.py:52 for the port); SGLD with its noise
    on, HMC at T=1 with the M-H test on and its exact passes grouped"""
    temps = [0.0, 0.5, 1.0, 1.0] if name == "SGLD" else 1.0
    extra = {"reject_samples": True} if name == "HMCReject" else {}
    runs = []
    for group in (None,) + sizes:
        tr = _port_runner(name, n_chains=4, temperatures=temps,
                          chain_group_size=group, **extra)
        hist = tr.run()
        runs.append((tr, hist))
        assert len(tr._groups()) == 4 // (group or 4)
    ref, rhist = runs[0]
    for tr, hist in runs[1:]:
        for a, b in zip(hist, rhist):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert torch.equal(tr.chains.position, ref.chains.position)
        assert torch.equal(tr.chains.momentum, ref.chains.momentum)
        assert all(torch.equal(v, ref.buffers[k])
                   for k, v in tr.buffers.items())
        if name == "HMCReject":
            np.testing.assert_array_equal(np.stack(tr.delta_energies),
                                          np.stack(ref.delta_energies))
            np.testing.assert_array_equal(np.stack(tr.rejections),
                                          np.stack(ref.rejections))
