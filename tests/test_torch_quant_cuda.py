"""The int8 conv kernel (``csrc/int8_conv.cu``) against its plain version on
the card, and a quantized model served on the card. Needs an NVIDIA GPU
and ``nvcc`` (``-m cuda``); skips elsewhere. Imports nothing of JAX.

Bound: the kernel's output equal to the plain version's in every element
(the int32 sum is exact, and every float step rounds alike)."""

import numpy as np
import pytest
import torch

from streamyolo_torch.ops.int8_conv import int8_conv, int8_conv_plain
from streamyolo_torch.quant import calibrate_activations, quantize_state_dict

from .torch_port_helpers import require_cuda, tiny_model


def operands(n, c, co, h, w, k, groups, per_channel, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, c, h, w, generator=g) * 3).to(dtype)
    kq = torch.randint(-127, 128, (co, c // groups, k, k), generator=g, dtype=torch.int8)
    w_scale = torch.rand(co, generator=g) * 1e-2 + 1e-4
    act = (torch.rand(c, generator=g) * 0.05 + 0.01) if per_channel \
        else torch.tensor(float(x.float().abs().max()) / 127.0)
    return x, kq, w_scale, act


CASES = [  # n, c, co, h, w, k, stride, groups, per_channel
    (1, 12, 64, 30, 48, 3, 1, 1, False),   # the Focus stem's 12 channels
    (2, 64, 128, 75, 120, 3, 2, 1, False),  # odd extents under stride 2
    (1, 256, 256, 38, 60, 1, 1, 1, True),
    (8, 32, 48, 19, 30, 3, 2, 1, True),
    (2, 48, 48, 13, 17, 3, 1, 48, False),   # depthwise
    (1, 40, 24, 9, 11, 1, 2, 1, False),     # C_in not a multiple of 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,co,h,w,k,stride,groups,per_channel", CASES)
def test_kernel_equals_plain(n, c, co, h, w, k, stride, groups, per_channel, dtype):
    require_cuda()
    x, kq, ws, act = operands(n, c, co, h, w, k, groups, per_channel, dtype)
    dev = torch.device("cuda")
    xd = x.to(dev).contiguous(memory_format=torch.channels_last)
    before = int8_conv.launches
    got = int8_conv(xd, kq.to(dev), ws.to(dev), act.to(dev), stride=stride, groups=groups)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    want = int8_conv_plain(x, kq, ws, act, stride, groups)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_edge_inputs():
    """An all-zero input at the scale floor, exact .5 ties and values past
    +-127, and an NCHW-contiguous input (copied to channels_last); a
    strided input is refused."""
    require_cuda()
    dev = torch.device("cuda")
    _, kq, ws, _ = operands(2, 32, 16, 7, 9, 3, 1, False, torch.float32)
    ties = (torch.randint(-300, 301, (2, 32, 7, 9), generator=torch.Generator().manual_seed(1))
            / 2.0)
    for x, act in ((torch.zeros(2, 32, 7, 9), torch.tensor(1e-8 / 127.0)),
                   (ties, torch.tensor(1.0)), (ties, torch.tensor(0.5))):
        got = int8_conv(x.to(dev), kq.to(dev), ws.to(dev), act.to(dev))
        assert torch.equal(got.cpu(), int8_conv_plain(x, kq, ws, act))
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        int8_conv(ties.to(dev)[:, :, ::2], kq.to(dev), ws.to(dev), torch.tensor(1.0, device=dev))


@pytest.mark.cuda
def test_quantized_model_on_the_card():
    """A quantized float32 tiny model (TF32 off): one kernel launch per
    quantized conv call, scales float32 on the card, decoded boxes within
    1e-3 relative and scores within 1e-3 of the same model on the CPU (the
    two devices' float32 BN / SiLU may flip an int8 code here and there)."""
    require_cuda()
    torch.backends.cudnn.allow_tf32 = False
    model = tiny_model(torch.float32).cpu()
    x = np.random.RandomState(0).randint(0, 256, (2, 64, 96, 6)).astype(np.uint8)
    q = quantize_state_dict(model.state_dict(), calibrate_activations(model, [x]))
    model.load_state_dict(q, strict=True)
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1)) for m in model.modules()
             if getattr(m, "kernel_q", None) is not None]
    with torch.no_grad():
        want = model(torch.from_numpy(x), mode="off_pipe")
    card = model.to("cuda").to(memory_format=torch.channels_last)
    stem = card.backbone.backbone.stem.conv
    assert stem.w_scale.dtype == torch.float32 and stem.w_scale.is_cuda
    n_calls = len(calls)
    before = int8_conv.launches
    with torch.no_grad():
        got = card(torch.from_numpy(x).cuda(), mode="off_pipe")
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert int8_conv.launches - before == len(calls) - n_calls == n_calls > 20
    assert torch.isfinite(got).all()
    rel = ((got.cpu() - want).abs() / (want.abs() + 1.0))
    torch.backends.cudnn.allow_tf32 = True
    assert float(rel[..., :4].max()) < 1e-3
    assert float((got.cpu() - want)[..., 4:].abs().max()) < 1e-3
