"""The fused update's noise stream and the CUDA kernel's wrapper checks.

The CUDA kernel draws ξ with Philox4x32-10 keyed by (seed, element index
within the chain) and Box–Muller on each pair of words; the plain PyTorch
version (`fused_update.philox_normals`) computes the same words and normals
in torch integer arithmetic, so the CPU and the card draw the same noise
and `chip_smoke.py` can hold the kernel against its plain version with the
noise on. These tests check that stream on the CPU: Random123's known
answers, its keying by element index, its chain and seed-offset forms and
its statistics; then the wrapper's checks and the kernel build's failure
modes, which run here without nvcc.
"""
import math
import os
import stat

import numpy as np
import pytest
import scipy.stats
import torch

from bnn_priors_tpu_torch.ops import _cuda_lib
from bnn_priors_tpu_torch.ops import fused_update as fu

from test_torch_models import torch_threads_per_worker  # noqa: F401

U32 = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((U32,) * 4, (U32, U32), (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, expected):
    "Random123's known-answer vectors for Philox4x32-10"
    out = fu.philox4x32_10(*counter, *key)
    assert tuple(int(w) for w in out) == expected
    # the same words when the counter is one entry of a batch
    batch = fu.philox4x32_10(torch.tensor([counter[0], 5, counter[0]]),
                             *counter[1:], *key)
    assert [int(w[0]) for w in batch] == list(expected)
    assert [int(w[2]) for w in batch] == list(expected)


def test_normals_are_box_muller_on_the_words():
    """element 4j and 4j+1 are r·cos and r·sin of the pair (x0, x1) of
    counter j, elements 4j+2 and 4j+3 of (x2, x3), in float64"""
    seed = 2 ** 40 + 12345
    T = 4 * 64
    xi = fu.philox_normals(torch.tensor([seed]), T, torch.float64)[0].numpy()
    j = torch.arange(T // 4)
    words = [w.numpy() for w in fu.philox4x32_10(
        j, 0, 0, 0, seed & U32, seed >> 32)]
    for a, b, first in ((0, 1, 0), (2, 3, 2)):
        u1 = 1.0 - (words[a] >> 8) * 2.0 ** -24
        u2 = (words[b] >> 8) * 2.0 ** -24
        r = np.sqrt(-2.0 * np.log(u1))
        np.testing.assert_allclose(xi[first::4], r * np.cos(2 * np.pi * u2),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(xi[first + 1::4], r * np.sin(2 * np.pi * u2),
                                   rtol=1e-14, atol=1e-14)


def _noise_update(T, total, seeds, sigma=1.0, dtype=torch.float32,
                  seed_offset=0):
    """m' of the chain plain version with mom_decay = grad_lr = 0: the noise
    σ·ξ itself, masked off the padding tail"""
    K = len(seeds)
    z = lambda: torch.zeros(K, T, dtype=dtype)
    o = lambda: torch.ones(K, T, dtype=dtype)
    m = z()
    fu.fused_langevin_update_chains_reference(
        z(), m, o(), z(), o(), torch.tensor(seeds, dtype=torch.int64),
        torch.full((K,), sigma, dtype=dtype), (0.0, 0.0, 0.0, 1.0),
        total=total, seed_offset=seed_offset)
    return m


def test_normals_are_keyed_by_the_element_index():
    "a draw at index i is the same for any T, total or K"
    seed = 987654321
    long = fu.philox_normals(torch.tensor([seed]), 8192)[0]
    short = fu.philox_normals(torch.tensor([seed]), 1024)[0]
    assert torch.equal(long[:1024], short)
    for T, total in ((1024, 1024), (3072, 2999), (8192, 5001)):
        one = _noise_update(T, total, [seed])[0]
        assert torch.equal(one[:total], long[:total])
        assert torch.equal(one[total:], torch.zeros(T - total))
        bank = _noise_update(T, total, [11, seed, 12, seed])
        assert torch.equal(bank[1], one) and torch.equal(bank[3], one)
        assert not torch.equal(bank[0], bank[2])
    # the single-chain plain version draws the same noise
    m = torch.zeros(3072)
    fu.fused_langevin_update_reference(
        torch.zeros(3072), m, torch.ones(3072), torch.zeros(3072),
        torch.ones(3072), seed, (0.0, 0.0, 1.0, 0.0, 1.0), total=2999)
    assert torch.equal(m[:2999], long[:2999])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chain_rows_equal_single_chain_with_noise_on(dtype):
    """row k of the (K, T) plain version, noise on with per-chain σ, equals
    the (T,) plain version with chain k's seed and σ, bit for bit"""
    K, T, total = 3, 3072, 3000
    rng = np.random.RandomState(0)
    mask = (np.arange(T) < total)
    arrs = [rng.randn(K, T) * mask for _ in range(3)]
    arrs.insert(2, (np.abs(rng.randn(K, T)) + 0.1) * mask)   # v
    arrs.append(np.abs(rng.randn(K, T)) + 0.5)               # M
    seeds = torch.tensor([3, 2 ** 62 - 5, 2 ** 33 + 1])
    sigma = torch.tensor([0.2, 1.0, 3.5], dtype=dtype)
    coeffs = (0.9, -0.05, 0.01, 0.99)
    bank = [torch.tensor(a, dtype=dtype) for a in arrs]       # copies
    *_, parts = fu.fused_langevin_update_chains_reference(
        *bank, seeds, sigma, coeffs, total=total)
    for k in range(K):
        row = [torch.tensor(a[k], dtype=dtype) for a in arrs]
        *_, p = fu.fused_langevin_update_reference(
            *row, int(seeds[k]),
            (coeffs[0], coeffs[1], float(sigma[k]), coeffs[2], coeffs[3]),
            total=total)
        for i in range(3):
            assert torch.equal(bank[i][k], row[i])
        np.testing.assert_allclose(parts[k].numpy(), p.numpy(), rtol=1e-6)
    # chain 2's momentum moved by its own σ·ξ (σ = 3.5)
    m_no_noise = coeffs[0] * arrs[1][2] + coeffs[1] * arrs[4][2] * arrs[3][2]
    resid = bank[1][2, :total].numpy() - m_no_noise[:total]
    assert abs(resid.std() - 3.5) < 0.3


def test_seed_offset_equals_adding_it_to_the_seeds():
    "seeds + n and seed_offset=n draw the same noise, in both wrappers"
    T, total = 2048, 2000
    keys = [5, 2 ** 61, 77]
    n = 41
    by_offset = _noise_update(T, total, keys, sigma=0.7, seed_offset=n)
    by_seeds = _noise_update(T, total, [s + n for s in keys], sigma=0.7)
    assert torch.equal(by_offset, by_seeds)
    assert not torch.equal(by_offset, _noise_update(T, total, keys, 0.7))
    # the CPU wrapper passes the offset to the plain version
    z = lambda: torch.zeros(3, T)
    o = lambda: torch.ones(3, T)
    m = z()
    fu.fused_langevin_update_chains(
        z(), m, o(), z(), o(), torch.tensor(keys), torch.full((3,), 0.7),
        (0.0, 0.0, 0.0, 1.0), total=total, seed_offset=n)
    assert torch.equal(m, by_offset)


def test_noise_moments_and_ks():
    "2^16 draws a seed: mean, std, KS; two seeds uncorrelated"
    n = 1 << 16
    xi = fu.philox_normals(torch.tensor([123, 124]), n, torch.float64).numpy()
    for x in xi:
        assert abs(x.mean()) < 4.0 / math.sqrt(n)
        assert abs(x.std() - 1.0) < 4.0 / math.sqrt(2 * n)
        assert scipy.stats.kstest(x, "norm").pvalue > 1e-3
        assert abs(scipy.stats.skew(x)) < 0.05
        assert abs(scipy.stats.kurtosis(x)) < 0.1
    assert abs(np.corrcoef(xi)[0, 1]) < 4.0 / math.sqrt(n)
    # float32 draws are the float64 ones to a few ulps of logf/sinf/cosf
    xi32 = fu.philox_normals(torch.tensor([123, 124]), n).double().numpy()
    np.testing.assert_allclose(xi32, xi, rtol=0, atol=1e-5)


def _state(T=2048, K=None, dtype=torch.float32):
    shape = (T,) if K is None else (K, T)
    return [torch.zeros(shape, dtype=dtype) for _ in range(5)]


def test_wrapper_checks_alignment_dtype_and_device():
    "what the kernel does not take raises, on the CPU too; no fallback"
    coeffs = (0.9, -0.05, 0.3, 0.01, 0.99)
    # a view 4 bytes into a buffer: contiguous but not 16-byte aligned
    buf = [torch.zeros(2048 + 4) for _ in range(5)]
    views = [b[1:2049] for b in buf]
    assert views[0].is_contiguous() and views[0].data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fu.fused_langevin_update(*views, 0, coeffs, total=2000)
    # 4 floats in: aligned again, and taken
    fu.fused_langevin_update(*[b[4:] for b in buf], 0, coeffs, total=2000)
    with pytest.raises(TypeError):
        fu.fused_langevin_update(*_state(dtype=torch.float16), 0, coeffs,
                                 total=2000)
    bank = [b.view(2, 1026)[:, 1:1025] for b in buf]   # rows not contiguous
    with pytest.raises(ValueError):
        fu.fused_langevin_update_chains(
            *bank, torch.arange(2), torch.zeros(2), coeffs[:2] + coeffs[3:],
            total=1000)
    # a device with no kernel raises rather than running the plain version
    before = (fu.launches, fu.chain_launches)
    meta = [t.to("meta") for t in _state()]
    with pytest.raises(ValueError, match="no kernel"):
        fu.fused_langevin_update(*meta, 0, coeffs, total=2000)
    with pytest.raises(ValueError, match="no kernel"):
        fu.fused_langevin_update_chains(
            *[t.to("meta") for t in _state(K=2)],
            torch.arange(2, device="meta"), torch.zeros(2, device="meta"),
            coeffs[:2] + coeffs[3:], total=2000)
    assert (fu.launches, fu.chain_launches) == before


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    "no nvcc: loading the kernel raises, and nothing is built or loaded"
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda_lib, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_cuda_lib, "lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_lib.load()
    assert not (tmp_path / "kernels").exists() and _cuda_lib.lib is None


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


def test_build_reports_the_compiler_and_leaves_no_partial_library(
        tmp_path, monkeypatch):
    "a failing nvcc raises with its output and leaves no file behind"
    _fake_nvcc(tmp_path, "while [ \"$1\" != -o ]; do shift; done\n"
               "echo partial > \"$2\"\n"
               "echo 'fused_update.cu(7): error: boom' >&2\nexit 2\n")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    build_dir = tmp_path / "kernels"
    with pytest.raises(RuntimeError, match="error: boom"):
        _cuda_lib.build(str(build_dir))
    assert os.listdir(build_dir) == []


def test_build_names_the_library_by_source_and_flags(tmp_path, monkeypatch):
    """a working nvcc: the library lands under a name hashed from the
    source and the flags, with the compiler's report beside it, and a
    second build finds it without compiling"""
    calls = tmp_path / "calls"
    _fake_nvcc(tmp_path, f"echo ptxas info: Used 40 registers\n"
               f"echo x >> {calls}\n"
               "while [ \"$1\" != -o ]; do shift; done\necho lib > \"$2\"\n")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    build_dir = str(tmp_path / "kernels")
    path = _cuda_lib.build(build_dir)
    assert path == _cuda_lib.library_path(build_dir)
    assert sorted(os.listdir(build_dir)) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".log"])
    assert "Used 40 registers" in _cuda_lib.build_log(build_dir)
    assert _cuda_lib.build(build_dir) == path
    assert calls.read_text().count("x") == 1
    monkeypatch.setattr(_cuda_lib, "NVCC_FLAGS",
                        _cuda_lib.NVCC_FLAGS + ("--use_fast_math",))
    assert _cuda_lib.library_path(build_dir) != path
