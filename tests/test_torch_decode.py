"""The head's decode (``eval_outputs``) of the PyTorch port against the JAX
package on the same maps, in bf16 and fp32.

Seeded numpy maps, rounded to the working dtype, go through the JAX
``eval_outputs`` (NHWC, run op by op) and the port's (NCHW): three levels
at strides 8/16/32, C = 5 + 8. In bf16 the two must be equal bit for bit:
both round the sigmoid's negate / exp / add / divide and the wh exp to bf16
and promote to float32 only at the grid and stride arithmetic. In fp32 the
expression is the same, but torch's and XLA's float32 ``exp`` may differ by
one ulp, so the tolerance is rtol 1e-6, atol 1e-7."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamyolo_tpu.models.heads import eval_outputs as j_eval_outputs
from streamyolo_torch.models.heads import eval_outputs

STRIDES = (8, 16, 32)
LEVELS = ((8, 12), (4, 6), (2, 3))  # a 64x96 input
CHANNELS = 13
JNP_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def head_maps(dtype, seed=0):
    """Per-level NHWC maps in ``dtype`` as torch tensors; N(0, 2) puts wh
    up to exp(8) and the probabilities across the whole sigmoid."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 2, (2, h, w, CHANNELS)).astype(np.float32)).to(dtype)
            for h, w in LEVELS]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_outputs_matches_jax(dtype):
    maps = head_maps(dtype)
    want = np.asarray(j_eval_outputs(
        [jnp.asarray(m.float().numpy()).astype(JNP_DTYPES[dtype]) for m in maps], STRIDES))
    got = eval_outputs([m.permute(0, 3, 1, 2) for m in maps], STRIDES)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape == (2, sum(h * w for h, w in LEVELS), CHANNELS)
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
