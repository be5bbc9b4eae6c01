"""The CUDA kernels (K1, K2, K2-split) against their plain PyTorch
versions, on a card. Every test is marked ``gpu`` and skips without a
CUDA device (the kernels are CUDA C++ with no CPU mode). This file imports
no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Tolerances: f32 inputs at ``atol = rtol = 2e-5`` (only the summation
order differs); bf16 at ``1e-2`` (one bf16 rounding of the output); the
logsumexp at ``1e-3``. Rows with no live key (and the left padding of
``valid_from`` rows) are unspecified and not compared."""

import pytest
import torch

from adapt_tpu_torch.ops import attention as TA
from adapt_tpu_torch.ops import decode_attention as TD

K1_CASES = {
    # name: (b, h, s_q, s_k, kwargs)
    "causal": (2, 3, 200, 200, dict(causal=True)),
    "noncausal_ragged_sk": (2, 2, 70, 197, dict(causal=False)),
    "window": (1, 2, 300, 300, dict(causal=True, window=64)),
    "valid_from": (3, 2, 130, 130, dict(causal=True, vf=[0, 7, 100])),
    "shift": (1, 2, 96, 96, dict(causal=True, shift=1)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_k1_matches_plain(cuda, name, dtype, d):
    b, h, s_q, s_k, kw = K1_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, h, s_q, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, h, s_k, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, h, s_k, d, generator=g, device=cuda).to(dtype)
    vf = torch.tensor(kw["vf"], device=cuda) if "vf" in kw else None
    n0 = TA.flash_attn_fwd.launches
    out, lse = TA.flash_attn_fwd(q, k, v, kw["causal"], vf, kw.get("shift"),
                                 kw.get("window"))
    torch.cuda.synchronize()
    assert TA.flash_attn_fwd.launches == n0 + 1
    ref, ref_lse = TA._reference_with_lse(q, k, v, kw["causal"], vf,
                                          kw.get("shift"), kw.get("window"))
    ok = ref_lse > -1e29
    if vf is not None:
        ok &= (torch.arange(s_q, device=cuda)[None, :] >= vf[:, None])[:, None]
    tol = _tol(dtype)
    torch.testing.assert_close(out.float()[ok], ref.float()[ok],
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse[ok], ref_lse[ok], atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(cuda, split, g, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, kvh, L, hd = 4, 3, 1025, 64
    q = torch.randn(b, kvh, g, hd, generator=gen, device=cuda).to(dtype)
    ck = torch.randn(b, kvh, L, hd, generator=gen, device=cuda).to(dtype)
    cv = torch.randn(b, kvh, L, hd, generator=gen, device=cuda).to(dtype)
    idx = torch.tensor([1024, 0, 517, 64], device=cuda, dtype=torch.int32)
    vf = (idx // 3).to(torch.int32)
    for valid_from in (None, vf):
        got = TD.decode_attention(q, ck, cv, idx, valid_from, split=split)
        torch.cuda.synchronize()
        ref = TD.decode_attention_plain(q, ck, cv, idx, valid_from, split)
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.gpu
def test_k2_split_one_equals_split_four(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(8, 12, 1, 64, generator=gen, device=cuda)
    ck = torch.randn(8, 12, 1025, 64, generator=gen, device=cuda)
    cv = torch.randn(8, 12, 1025, 64, generator=gen, device=cuda)
    idx = torch.linspace(0, 1024, 8, device=cuda).to(torch.int32)
    a = TD.decode_attn(q, ck, cv, idx)
    b = TD.decode_attn_split(q, ck, cv, idx, None, 4)
    torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_cuda_refuses_plain_and_grad(cuda):
    x = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="refuse"):
        TA.flash_attention(x, x, x, prefer="xla")
    with pytest.raises(ValueError, match="refuse"):
        TD.decode_attention(x[:, :, :1], x, x, 0, prefer="xla")
    with pytest.raises(NotImplementedError, match="K7"):
        TA.flash_attention(x.clone().requires_grad_(), x, x)
    with pytest.raises(ValueError, match="head_dim"):
        TA.flash_attn_fwd(x[..., :32], x[..., :32], x[..., :32])
