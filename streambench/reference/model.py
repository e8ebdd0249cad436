"""StreamYOLO's forward in plain float32 PyTorch: the benchmark's reference.

Written from the published architecture (YOLOX's CSPDarknet with the Focus
stem and SPP, the PAFPN neck, StreamYOLO's DFP fuse and its decoupled TAL
head, the anchor-free decode), with no kernel, cache or batching of the
program under test; it imports nothing of it. Parameters are a flat dict of
tensors under the yolox ``state_dict`` names, so the benchmark can hand the
same seeded weights to the program and to this file.

Every convolution goes through ``ops.conv``: ``PlainOps`` runs it in
float32, ``count.CountingOps`` counts its work on meta tensors, and
``control.Fp8Ops`` rounds its operands through float8 (the control that
has to fail the comparison). BatchNorm uses its running statistics (eval);
``CalibratingOps`` sets them from the batch it sees first.

Shapes: frames are NHWC uint8 (BGR, 0..255, no normalisation); inside,
NCHW. Decoded predictions are [B, N, 5 + C] rows (cx, cy, w, h, obj, cls...)
with the anchors row-major per level, levels in stride order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
STRIDES = (8, 16, 32)
IN_CHANNELS = (256, 512, 1024)

Params = Dict[str, torch.Tensor]


class PlainOps:
    """The reference's convolution: float32, as written."""

    def conv(self, x, w, b, stride: int, pad: int, groups: int = 1):
        return F.conv2d(x, w, b, stride, pad, 1, groups)


VAR_FLOOR = 1.0  # times the layer's mean variance, added to each channel's


class CalibratingOps(PlainOps):
    """Float32 operations that set each BatchNorm's running statistics to
    the per-channel mean and variance of its input before it normalises
    (the variance raised by a hundredth of the layer's mean, so that a
    channel all but constant on these frames does not blow up on others):
    the state of a trained network's BatchNorm in eval mode."""

    def observe(self, p: Params, bn: str, y: torch.Tensor) -> None:
        var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
        p[bn + "running_mean"] = mean
        p[bn + "running_var"] = var + VAR_FLOOR * var.mean()


class Conv:
    """Conv (no bias) -> BatchNorm (running statistics) -> SiLU, padding
    (k - 1) // 2: YOLOX's ``BaseConv``."""

    def __init__(self, name: str, cin: int, cout: int, k: int, stride: int = 1,
                 kind: str = "conv"):
        self.name, self.cin, self.cout, self.k, self.stride = name, cin, cout, k, stride
        self.kind = kind

    def spec(self):
        yield self.name + ".conv.weight", (self.cout, self.cin, self.k, self.k), self.kind
        for part, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            yield f"{self.name}.bn.{part}", (self.cout,), kind
        yield self.name + ".bn.num_batches_tracked", (), "count"

    def __call__(self, p: Params, ops, x):
        y = ops.conv(x, p[self.name + ".conv.weight"], None, self.stride, (self.k - 1) // 2)
        bn = self.name + ".bn."
        if isinstance(ops, CalibratingOps):
            ops.observe(p, bn, y)
        scale = p[bn + "weight"] / torch.sqrt(p[bn + "running_var"] + BN_EPS)
        y = (y - p[bn + "running_mean"][:, None, None]) * scale[:, None, None] \
            + p[bn + "bias"][:, None, None]
        return F.silu(y)


class Bottleneck:
    def __init__(self, name: str, cin: int, cout: int, shortcut: bool):
        self.conv1 = Conv(name + ".conv1", cin, cout, 1)
        self.conv2 = Conv(name + ".conv2", cout, cout, 3)
        self.add = shortcut and cin == cout

    def spec(self):
        yield from self.conv1.spec()
        yield from self.conv2.spec()

    def __call__(self, p, ops, x):
        y = self.conv2(p, ops, self.conv1(p, ops, x))
        return y + x if self.add else y


class CSP:
    """Cross-stage-partial layer: two 1x1 halves, ``n`` bottlenecks on one,
    concatenated and fused by a 1x1."""

    def __init__(self, name: str, cin: int, cout: int, n: int, shortcut: bool = True):
        hidden = cout // 2
        self.conv1 = Conv(name + ".conv1", cin, hidden, 1)
        self.conv2 = Conv(name + ".conv2", cin, hidden, 1)
        self.conv3 = Conv(name + ".conv3", 2 * hidden, cout, 1)
        self.m = [Bottleneck(f"{name}.m.{i}", hidden, hidden, shortcut) for i in range(n)]

    def spec(self):
        for part in (self.conv1, self.conv2, self.conv3, *self.m):
            yield from part.spec()

    def __call__(self, p, ops, x):
        a = self.conv1(p, ops, x)
        for b in self.m:
            a = b(p, ops, a)
        return self.conv3(p, ops, torch.cat([a, self.conv2(p, ops, x)], dim=1))


class SPP:
    """1x1 reduce, max-pools 5 / 9 / 13 (stride 1, same padding), concat,
    1x1."""

    def __init__(self, name: str, cin: int, cout: int):
        hidden = cin // 2
        self.conv1 = Conv(name + ".conv1", cin, hidden, 1)
        self.conv2 = Conv(name + ".conv2", hidden * 4, cout, 1)

    def spec(self):
        yield from self.conv1.spec()
        yield from self.conv2.spec()

    def __call__(self, p, ops, x):
        x = self.conv1(p, ops, x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)]
        return self.conv2(p, ops, torch.cat([x, *pools], dim=1))


class StreamYOLO:
    """StreamYOLO (DFP-PAFPN + TAL head) at ``depth`` / ``width`` with
    ``num_classes`` classes."""

    def __init__(self, depth: float, width: float, num_classes: int):
        self.num_classes = num_classes
        c = int(width * 64)
        d = max(round(depth * 3), 1)
        bb = "backbone.backbone."
        self.stem = Conv(bb + "stem.conv", 12, c, 3, kind="stem_conv")
        self.dark = [
            [Conv(bb + "dark2.0", c, 2 * c, 3, 2), CSP(bb + "dark2.1", 2 * c, 2 * c, d)],
            [Conv(bb + "dark3.0", 2 * c, 4 * c, 3, 2), CSP(bb + "dark3.1", 4 * c, 4 * c, 3 * d)],
            [Conv(bb + "dark4.0", 4 * c, 8 * c, 3, 2), CSP(bb + "dark4.1", 8 * c, 8 * c, 3 * d)],
            [Conv(bb + "dark5.0", 8 * c, 16 * c, 3, 2), SPP(bb + "dark5.1", 16 * c, 16 * c),
             CSP(bb + "dark5.2", 16 * c, 16 * c, d, shortcut=False)],
        ]
        ic = [int(ch * width) for ch in IN_CHANNELS]
        n = round(3 * depth)
        fp = "backbone."
        self.lateral_conv0 = Conv(fp + "lateral_conv0", ic[2], ic[1], 1)
        self.C3_p4 = CSP(fp + "C3_p4", 2 * ic[1], ic[1], n, False)
        self.reduce_conv1 = Conv(fp + "reduce_conv1", ic[1], ic[0], 1)
        self.C3_p3 = CSP(fp + "C3_p3", 2 * ic[0], ic[0], n, False)
        self.bu_conv2 = Conv(fp + "bu_conv2", ic[0], ic[0], 3, 2)
        self.C3_n3 = CSP(fp + "C3_n3", 2 * ic[0], ic[1], n, False)
        self.bu_conv1 = Conv(fp + "bu_conv1", ic[1], ic[1], 3, 2)
        self.C3_n4 = CSP(fp + "C3_n4", 2 * ic[1], ic[2], n, False)
        self.jian = [Conv(f"{fp}jian{2 - i}", ic[i], ic[i] // 2, 1) for i in range(3)]
        feat = int(256 * width)
        self.head = []
        for k, ch in enumerate(ic):
            self.head.append({
                "stem": Conv(f"head.stems.{k}", ch, feat, 1),
                "cls": [Conv(f"head.cls_convs.{k}.{i}", feat, feat, 3) for i in range(2)],
                "reg": [Conv(f"head.reg_convs.{k}.{i}", feat, feat, 3) for i in range(2)],
                "pred": [(f"head.{kind}_preds.{k}", cout) for kind, cout in
                         (("cls", num_classes), ("reg", 4), ("obj", 1))],
            })
        self.feat = feat

    # --- parameters --------------------------------------------------------

    def _blocks(self):
        yield self.stem
        for stage in self.dark:
            yield from stage
        yield from (self.lateral_conv0, self.C3_p4, self.reduce_conv1, self.C3_p3,
                    self.bu_conv2, self.C3_n3, self.bu_conv1, self.C3_n4, *self.jian)
        for level in self.head:
            yield from (level["stem"], *level["cls"], *level["reg"])

    def spec(self) -> List[Tuple[str, tuple, str]]:
        """(name, shape, kind) of every parameter and BatchNorm buffer;
        ``kind`` is ``conv`` (a weight of fan-in ``shape[1:]``), ``stem_conv``
        (the first convolution, which reads 0..255 pixels), ``pred_conv``
        (the head's prediction convolutions), ``bn_weight``,
        ``bn_bias``, ``bn_mean``, ``bn_var``, ``count`` or ``pred_bias``."""
        out = []
        for block in self._blocks():
            out.extend(block.spec())
        for level in self.head:
            for name, cout in level["pred"]:
                out.append((name + ".weight", (cout, self.feat, 1, 1), "pred_conv"))
                out.append((name + ".bias", (cout,), "pred_bias"))
        return out

    # --- forward -----------------------------------------------------------

    def pafpn(self, p: Params, ops, x: torch.Tensor):
        """Backbone + PAFPN on NCHW float frames -> (pan_out2, pan_out1,
        pan_out0) at strides 8, 16, 32."""
        x = torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                       x[..., 1::2, 1::2]], dim=1)  # Focus: space to depth
        x = self.stem(p, ops, x)
        feats = []
        for stage in self.dark:
            for block in stage:
                x = block(p, ops, x)
            feats.append(x)
        x2, x1, x0 = feats[1:]

        def up(t, like):
            return F.interpolate(t, size=like.shape[-2:], mode="nearest")

        fpn_out0 = self.lateral_conv0(p, ops, x0)
        f_out0 = self.C3_p4(p, ops, torch.cat([up(fpn_out0, x1), x1], dim=1))
        fpn_out1 = self.reduce_conv1(p, ops, f_out0)
        pan_out2 = self.C3_p3(p, ops, torch.cat([up(fpn_out1, x2), x2], dim=1))
        pan_out1 = self.C3_n3(p, ops, torch.cat([self.bu_conv2(p, ops, pan_out2), fpn_out1], 1))
        pan_out0 = self.C3_n4(p, ops, torch.cat([self.bu_conv1(p, ops, pan_out1), fpn_out0], 1))
        return pan_out2, pan_out1, pan_out0

    def fuse(self, p: Params, ops, cur, sup):
        """DFP: cat(jian(cur), jian(sup)) + cur at each level."""
        return tuple(torch.cat([j(p, ops, c), j(p, ops, s)], dim=1) + c
                     for j, c, s in zip(self.jian, cur, sup))

    def head_maps(self, p: Params, ops, feats) -> List[torch.Tensor]:
        """Raw per-level maps [B, 4 + 1 + C, H, W] (reg, obj, cls)."""
        out = []
        for level, x in zip(self.head, feats):
            x = level["stem"](p, ops, x)
            c = r = x
            for conv in level["cls"]:
                c = conv(p, ops, c)
            for conv in level["reg"]:
                r = conv(p, ops, r)
            (cls_name, _), (reg_name, _), (obj_name, _) = level["pred"]

            def pred(name, t):
                return ops.conv(t, p[name + ".weight"], p[name + ".bias"], 1, 0)

            out.append(torch.cat([pred(reg_name, r), pred(obj_name, r), pred(cls_name, c)], 1))
        return out

    def detect(self, p: Params, ops, feats) -> torch.Tensor:
        """Head, sigmoid of obj / cls, flatten, decode -> [B, N, 5 + C]."""
        return decode(self.head_maps(p, ops, feats))

    def frames_in(self, frames: torch.Tensor) -> torch.Tensor:
        """NHWC uint8 frames -> NCHW float32 (values 0..255)."""
        return frames.to(torch.float32).permute(0, 3, 1, 2)


def anchors(hw: Sequence[Tuple[int, int]], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grid [N, 2] as (x, y) cell indices, stride [N]) of the levels' maps,
    row-major per level, levels in stride order."""
    grids, strides = [], []
    for (h, w), s in zip(hw, STRIDES):
        ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                                indexing="ij")
        grids.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1))
        strides.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(grids).to(torch.float32), torch.cat(strides)


def decode(maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Raw per-level maps -> [B, N, 5 + C]: xy = (t + grid) * stride,
    wh = exp(t) * stride, obj and cls through the sigmoid."""
    grid, stride = anchors([tuple(m.shape[-2:]) for m in maps], maps[0].device)
    flat = torch.cat([m.flatten(2).transpose(1, 2) for m in maps], dim=1)
    s = stride[None, :, None]
    return torch.cat([(flat[..., :2] + grid[None]) * s, torch.exp(flat[..., 2:4]) * s,
                      torch.sigmoid(flat[..., 4:])], dim=-1)
