"""The 0.5x streaming preprocess of the PyTorch port against the JAX
package: the plain downsample must be bit-equal to the Pallas kernel
(interpret mode) and its jnp oracle; the fused round + cast must equal the
detector step of ``streamyolo_tpu/stream/online.py``. Kernel B2 itself needs
the card (``-m cuda``) and skips here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamyolo_tpu.ops.preproc_pallas import downsample2x_bilinear, downsample2x_reference
from streamyolo_torch.ops.preproc import downsample2x
from streamyolo_torch.ops.preproc import downsample2x_reference as t_reference

from .torch_port_helpers import require_cuda

JNP_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def frame(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("h,w", [(64, 96), (60, 32)])
def test_plain_downsample_bit_equal_to_jax(h, w):
    f = frame(h, w)
    want = np.asarray(downsample2x_bilinear(f, out_dtype=jnp.float32, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(downsample2x_reference(f)))
    got = t_reference(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, want)
    before = downsample2x.launches
    np.testing.assert_array_equal(downsample2x(torch.from_numpy(f)).numpy(), want)
    assert downsample2x.launches == before  # CPU tensor: plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_round_and_cast_match_stream_step(dtype):
    """online.py: ds = downsample; x = clip(floor(ds + 0.5), 0, 255) -> dtype."""
    f = frame(64, 96, seed=1)
    ds = downsample2x_reference(f)
    want = jnp.clip(jnp.floor(ds + 0.5), 0, 255).astype(JNP_DTYPES[dtype])
    got = downsample2x(torch.from_numpy(f), out_dtype=dtype, fused=True)
    assert got.dtype == dtype and got.shape == (32, 48, 3)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_downsample_rejects_bad_frames():
    with pytest.raises(ValueError):
        downsample2x(torch.zeros(63, 96, 3, dtype=torch.uint8))
    with pytest.raises(ValueError):
        downsample2x(torch.zeros(64, 96, 3))
    with pytest.raises(TypeError):
        downsample2x(torch.zeros(64, 96, 3, dtype=torch.uint8), out_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,offset", [(64, 96, 0), (60, 32, 0), (1200, 1920, 0), (2, 2, 0),
                                        (2, 34, 0), (1200, 1922, 0), (64, 96, 1),
                                        (1200, 1920, 1)])
def test_downsample_kernel_matches_plain_on_card(h, w, offset):
    """Every shape, mode and dtype bit-exact; ``offset`` puts the frame's
    data_ptr off the 16-byte grid (the kernel's per-pixel path), as does a
    width that is not a multiple of 16."""
    require_cuda()
    f = torch.from_numpy(frame(h, w)).cuda()
    if offset:
        store = torch.empty(f.numel() + 16, dtype=torch.uint8, device="cuda")
        f = store[offset:offset + f.numel()].view(h, w, 3).copy_(f)
        assert f.data_ptr() % 16 != 0 and f.is_contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        for fused in (False, True):
            before = downsample2x.launches
            got = downsample2x(f, out_dtype=dtype, fused=fused)
            torch.cuda.synchronize()
            assert downsample2x.launches == before + 1
            want = downsample2x(f.cpu(), out_dtype=dtype, fused=fused)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
