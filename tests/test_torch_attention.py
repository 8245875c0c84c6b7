"""Flash attention of the PyTorch port against the JAX package's.

The same numpy inputs go through the JAX Pallas kernels (interpret mode
on the CPU, as tests/test_ops.py runs them) and through the port, whose
wrappers take their plain PyTorch versions for CPU tensors. The CUDA
kernels themselves are held against those plain versions on the card
(tests/test_torch_kernels.py and chip_smoke.py).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.attention import _flash_fwd
from dlrover_tpu.ops.attention import flash_attention as jax_flash
from dlrover_tpu_torch.ops import attention as port
from dlrover_tpu_torch.ops.attention import flash_attention

# fp32: the same tolerances as tests/test_ops.py (1e-5 outputs, 1e-4
# gradients): the port computes the kernels' arithmetic unblocked, so
# only the summation order differs. bf16: 2e-2, the output's own
# rounding (2^-8 relative) plus bf16 rounding of the inputs' products.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(s, seed=0, b=2, h=2, d=64):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, g


def to_jax(x, dt):
    return jnp.asarray(x).astype(JAX_DT[dt])


def to_torch(x, dt, grad=False):
    return torch.tensor(x).to(TORCH_DT[dt]).requires_grad_(grad)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = [
    pytest.param(causal, s, dt, id=f"{'causal' if causal else 'full'}-S{s}-{dt}")
    for causal in (True, False)
    for s in (64, 96)
    for dt in ("float32", "bfloat16")
]


class TestAgainstJax:
    @pytest.mark.parametrize("causal,s,dt", CASES)
    def test_forward_and_grads(self, causal, s, dt):
        q, k, v, g = inputs(s)
        out_tol, grad_tol = TOL[dt]
        jq, jk, jv, jg = (to_jax(x, dt) for x in (q, k, v, g))

        def f(q_, k_, v_):
            return jax_flash(q_, k_, v_, causal=causal, block_q=32,
                             block_k=32)

        j_out, vjp = jax.vjp(f, jq, jk, jv)
        j_grads = vjp(jg)

        tq, tk, tv = (to_torch(x, dt, grad=True) for x in (q, k, v))
        t_out = flash_attention(tq, tk, tv, causal=causal)
        t_out.backward(to_torch(g, dt))
        assert t_out.dtype == TORCH_DT[dt]
        np.testing.assert_allclose(as_np(t_out), as_np(j_out),
                                   rtol=out_tol, atol=out_tol)
        for t, j in zip((tq, tk, tv), j_grads):
            assert t.grad.dtype == TORCH_DT[dt]
            np.testing.assert_allclose(as_np(t.grad), as_np(j),
                                       rtol=grad_tol, atol=grad_tol)

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("s", [64, 96])
    def test_lse_matches_jax(self, causal, s):
        q, k, v, _ = inputs(s, seed=1)
        _, j_lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, 32, 32, True)
        _, t_lse = port.flash_fwd(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal)
        assert t_lse.shape == (2, 2, s) and t_lse.dtype == torch.float32
        np.testing.assert_allclose(
            as_np(t_lse).reshape(4, 1, s), np.asarray(j_lse),
            rtol=1e-5, atol=1e-5,
        )


class TestPlainVersions:
    def test_reference_attention_matches_plain_forward(self):
        q, k, v, _ = (torch.tensor(x) for x in inputs(64, seed=2))
        o, _ = port._fwd_plain(q, k, v, True)
        ref = port.reference_attention(q, k, v, causal=True)
        np.testing.assert_allclose(as_np(o), as_np(ref), rtol=1e-5,
                                   atol=1e-5)

    def test_backward_plain_matches_autograd_of_reference(self):
        q, k, v, g = (torch.tensor(x) for x in inputs(64, seed=3))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        port.reference_attention(*leaves, causal=True).backward(g)
        o, lse = port._fwd_plain(q, k, v, True)
        delta = port.attention_delta(o, g)
        dq = port._bwd_dq_plain(q, k, v, g, lse, delta, True)
        dk, dv = port._bwd_dkv_plain(q, k, v, g, lse, delta, True)
        for got, leaf in zip((dq, dk, dv), leaves):
            np.testing.assert_allclose(as_np(got), as_np(leaf.grad),
                                       rtol=1e-4, atol=1e-4)


class TestKernelInputChecks:
    """The CUDA wrappers' validation runs before any launch, so it is
    checked here on CPU tensors."""

    def test_rejects_fp32(self):
        q = torch.zeros(1, 8, 1, 64)
        with pytest.raises(TypeError, match="bfloat16"):
            port._check(q, q, q)

    def test_rejects_other_head_dims(self):
        q = torch.zeros(1, 8, 1, 32, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="64"):
            port._check(q, q, q)

    def test_rejects_mismatched_kv(self):
        q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
        k = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="do not match"):
            port._check(q, k, k)

    def test_strided_views_are_read_in_place(self):
        qkv = torch.zeros(2, 16, 3 * 128, dtype=torch.bfloat16)
        q = qkv[..., 128:256].reshape(2, 16, 2, 64)
        assert port._aligned(q).data_ptr() == q.data_ptr()
        strides = port._strides(q)
        assert list(strides) == [16 * 384, 384, 64]
        assert isinstance(strides, ctypes.Array)

    def test_misaligned_views_are_copied(self):
        x = torch.zeros(2, 16, 2, 65, dtype=torch.bfloat16)[..., :64]
        assert port._aligned(x).is_contiguous()

    def test_other_devices_raise(self):
        q = torch.zeros(1, 8, 1, 64, device="meta")
        with pytest.raises(ValueError, match="no flash attention"):
            port.flash_fwd(q, q, q)
