"""DFP-PAFPN: PAFPN neck + Dual-Flow Perception fusion, in PyTorch.

Counterpart of ``streamyolo_tpu/models/dfp_pafpn.py``:

  * ``off_pipe``: a 6-channel (current ++ support) input runs the shared
    backbone+PAFPN on both frames and fuses each level with the ``jian``
    half-channel 1x1 convs, ``cat(jian(cur), jian(sup)) + cur``; a 3-channel
    input is self-duplicated. In eval both frames go through one batched
    pass, and a 3-channel input through one pass of its own.
  * ``on_pipe``: the backbone runs ONCE on the current frame and fuses with
    the carried previous-frame outputs (the DFP buffer); ``buffer=None`` is
    the star node (self-fuse). Returns ``(outputs, cur)``; ``cur`` is the
    next buffer. With a buffer, a ``[B]`` bool ``star_mask`` selects per
    row: a True row fuses with its own current features (a restarted
    stream's star), the other rows with the buffer, in one batched pass
    (``stream/online.py::MultiStreamDetector``).
  * ``seq`` (sequential-dedup offline eval, ``eval/seq_forward.py``): ONE
    pafpn pass over a batch of consecutive current frames; sample i's
    support features are the batch's own outputs at row
    ``i - support_shift[i]``, extended in front by a 2-frame carry of the
    previous batch's last outputs. Returns ``(outputs, carry)``. Eval only:
    BN uses running statistics, so the outputs are those of ``off_pipe`` at
    half the backbone work.

Tensors are NCHW (``channels_last`` on the card; the ``seq`` gather and
concatenations keep that layout).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from streamyolo_torch.models.darknet import CSPDarknet
from streamyolo_torch.nn.blocks import BaseConv, CSPLayer, DWConv
from streamyolo_torch.ops.resize import resize_nearest

# The DFP feature buffer: (pan_out2 /8, pan_out1 /16, pan_out0 /32), NCHW.
Buffer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class DFPPAFPN(nn.Module):
    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 in_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        self.in_features = tuple(in_features)
        ic = [int(c * width) for c in in_channels]
        Conv = DWConv if depthwise else BaseConv
        n = round(3 * depth)
        csp_kw = dict(shortcut=False, depthwise=depthwise, act=act)

        self.backbone = CSPDarknet(depth, width, depthwise=depthwise, act=act)
        self.lateral_conv0 = BaseConv(ic[2], ic[1], 1, 1, act=act)
        self.C3_p4 = CSPLayer(2 * ic[1], ic[1], n=n, **csp_kw)
        self.reduce_conv1 = BaseConv(ic[1], ic[0], 1, 1, act=act)
        self.C3_p3 = CSPLayer(2 * ic[0], ic[0], n=n, **csp_kw)
        self.bu_conv2 = Conv(ic[0], ic[0], 3, 2, act=act)
        self.C3_n3 = CSPLayer(2 * ic[0], ic[1], n=n, **csp_kw)
        self.bu_conv1 = Conv(ic[1], ic[1], 3, 2, act=act)
        self.C3_n4 = CSPLayer(2 * ic[1], ic[2], n=n, **csp_kw)
        self.jian2 = Conv(ic[0], ic[0] // 2, 1, 1, act=act)
        self.jian1 = Conv(ic[1], ic[1] // 2, 1, 1, act=act)
        self.jian0 = Conv(ic[2], ic[2] // 2, 1, 1, act=act)

    def pafpn(self, x: torch.Tensor) -> Buffer:
        """Backbone + PAFPN on 3-channel frames -> (pan_out2, pan_out1, pan_out0)."""
        feats = self.backbone(x)
        x2, x1, x0 = (feats[f] for f in self.in_features)

        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = torch.cat([resize_nearest(fpn_out0, x1.shape[-2:]), x1], dim=1)
        f_out0 = self.C3_p4(f_out0)

        fpn_out1 = self.reduce_conv1(f_out0)
        f_out1 = torch.cat([resize_nearest(fpn_out1, x2.shape[-2:]), x2], dim=1)
        pan_out2 = self.C3_p3(f_out1)

        p_out1 = torch.cat([self.bu_conv2(pan_out2), fpn_out1], dim=1)
        pan_out1 = self.C3_n3(p_out1)

        p_out0 = torch.cat([self.bu_conv1(pan_out1), fpn_out0], dim=1)
        pan_out0 = self.C3_n4(p_out0)
        return pan_out2, pan_out1, pan_out0

    def _dfp_fuse(self, cur: Buffer, sup: Buffer) -> Buffer:
        """cat(jian(cur), jian(sup)) + cur, per level."""
        jians = (self.jian2, self.jian1, self.jian0)
        return tuple(
            torch.cat([j(c), j(s)], dim=1) + c for j, c, s in zip(jians, cur, sup))

    def forward(self, x: torch.Tensor, buffer: Optional[Buffer] = None,
                mode: str = "off_pipe", star_mask: Optional[torch.Tensor] = None,
                support_shift: Optional[torch.Tensor] = None):
        if mode == "seq":
            if self.training or support_shift is None:
                raise ValueError("mode 'seq' is eval-only and needs support_shift")
            cur = self.pafpn(x)
            if buffer is None:
                # first batch: frame 0 twice as a placeholder (real datasets
                # give their first rows a shift <= the row index)
                carry = tuple(torch.cat([c[:1], c[:1]], dim=0) for c in cur)
            else:
                carry = tuple(b.to(c.dtype) for b, c in zip(buffer, cur))
            ext = tuple(torch.cat([k, c], dim=0) for k, c in zip(carry, cur))
            rows = torch.arange(x.shape[0], device=x.device) + 2 - support_shift
            sup = tuple(e[rows] for e in ext)
            return self._dfp_fuse(cur, sup), tuple(e[-2:] for e in ext)
        if mode == "off_pipe":
            if x.shape[1] == 3:
                if not self.training:  # BN uses running statistics: one pass
                    cur = self.pafpn(x)
                    return self._dfp_fuse(cur, cur)
                cur_img = sup_img = x
            else:
                cur_img, sup_img = x[:, :3], x[:, 3:]
            if not self.training:
                # one pass over both halves: BN uses running statistics, so
                # the math is that of two passes, at one launch sequence
                b = cur_img.shape[0]
                both = self.pafpn(torch.cat([cur_img, sup_img], dim=0))
                return self._dfp_fuse(tuple(o[:b] for o in both), tuple(o[b:] for o in both))
            # two passes: a joint batch would mix the BN batch statistics
            return self._dfp_fuse(self.pafpn(cur_img), self.pafpn(sup_img))
        if mode == "on_pipe":
            cur = self.pafpn(x)
            sup = cur if buffer is None else tuple(buffer)
            if buffer is not None and star_mask is not None:
                m = star_mask.reshape(-1, 1, 1, 1)
                sup = tuple(torch.where(m, c, s.to(c.dtype)) for c, s in zip(cur, sup))
            return self._dfp_fuse(cur, sup), cur
        raise ValueError(f"mode must be 'off_pipe', 'on_pipe' or 'seq', got {mode!r}")
