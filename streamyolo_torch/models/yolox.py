"""StreamYOLO composite model (DFP-PAFPN backbone + decoupled head) in
PyTorch, the counterpart of ``streamyolo_tpu/models/yolox.py``.

The public boundary keeps the JAX layout: the model takes NHWC input
(uint8 or float) and returns predictions ``[B, N, 5+C]``. Inside, tensors
are NCHW. A non-float input is cast to the modules' dtype, so a model
built bf16 computes bf16 end to end (the JAX modules cast to their compute
dtype the same way).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from streamyolo_torch.models.dfp_pafpn import DFPPAFPN, Buffer
from streamyolo_torch.models.heads import TALHead, YOLOXHead, eval_outputs
from streamyolo_torch.utils.device import resolve_device

# depth, width of the shipped configs (cfgs/*.py)
WIDTHS = {"s": (0.33, 0.50), "m": (0.67, 0.75), "l": (1.0, 1.0)}


class StreamYOLO(nn.Module):
    def __init__(self, backbone: DFPPAFPN, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def forward(self, x: torch.Tensor, buffer: Optional[Buffer] = None,
                mode: str = "off_pipe"):
        """``off_pipe``: NHWC 6- (or 3-) channel input -> decoded
        ``[B, N, 5+C]`` (raw per-level maps in training).
        ``on_pipe``: NHWC 3-channel frame + DFP buffer (``None`` = star) ->
        ``(decoded, new_buffer)``; the buffer is a tuple of NCHW maps."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if mode == "off_pipe":
            outputs = self.head(self.backbone(x, mode="off_pipe"))
            if self.training:
                return outputs
            return eval_outputs(outputs, self.head.strides)
        if mode == "on_pipe":
            fpn_outs, new_buffer = self.backbone(x, buffer=buffer, mode="on_pipe")
            outputs = self.head(fpn_outs)
            return eval_outputs(outputs, self.head.strides), new_buffer
        raise ValueError(f"mode must be 'off_pipe' or 'on_pipe', got {mode!r}")


YOLOX = StreamYOLO


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv weight from ``generator`` with the JAX package's
    default conv init, LeCun normal N(0, 1/fan_in) (it keeps activations at
    scale through the deep trunk; torch's default shrinks them), zero the
    pred-conv biases, then put back the head's prior-prob biases. BatchNorm
    stays at identity statistics. The generator must be on the parameters'
    device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        for m in model.modules():
            if isinstance(m, YOLOXHead):
                m.initialize_biases(m.prior_prob)
    return model


def build_streamyolo(
    size: str = "l",
    num_classes: int = 8,
    *,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> StreamYOLO:
    """StreamYOLO-s/m/l with the TAL head, as the shipped streaming configs
    build it (``get_model`` of ``exp/stream_exp.py``), in eval mode, with
    modules cast to ``dtype``.
    With ``generator`` (a CPU generator) the weights are drawn from it
    (``init_weights``) before the model moves to ``device``."""
    dev = resolve_device(device)
    depth, width = WIDTHS[size]
    model = StreamYOLO(
        backbone=DFPPAFPN(depth, width),
        head=TALHead(num_classes=num_classes, width=width),
    )
    if generator is not None:
        init_weights(model, generator)
    return model.to(device=dev, dtype=dtype).eval()
