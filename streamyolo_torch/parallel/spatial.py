"""The row-sharded latency mode, the counterpart of
``streamyolo_tpu/parallel/spatial.py``: one frame's rows sliced across
devices, so that one stream runs on more than one device.

The JAX package puts only the input image under an H-axis
``NamedSharding``; GSPMD then turns every convolution into a local conv
plus a halo exchange, pads the uneven pyramid levels and gathers once at the
decode / NMS tail. torch has no partitioner, so this module does that work
by hand, keyed by module type, without changing the model's modules:

  * a sharded feature map (``Rows``) is one NCHW slab per mesh device in the
    canonical partition of its global height H (GSPMD's padded split: chunks
    of ``ceil(H / n)`` rows, so the last shards may be short or empty);
  * BN (eval), SiLU, 1x1 convs, channel concatenation, the residual add and
    the DFP fuse are local;
  * a windowed op (``BaseConv`` 3x3 at stride 1 and 2, ``DWConv``, the SPP
    max-pools, ``Focus``'s 2x2 space-to-depth as a (k = 2, s = 2) window)
    computes output rows ``[o0, o1)`` of device i from input rows
    ``[o0 s - p, (o1 - 1) s - p + k)`` clipped to ``[0, H)``, fetched from
    whichever shards hold them (the halo exchange: plain device-to-device
    copies), with the slab's first row moved up to a multiple of ``s``. The
    module runs unchanged on that slab, padding it itself (zeros for a
    conv, -inf for a pool; the int8 kernel pads itself too), and the output
    rows whose window touched the slab's own padding are cropped: only at
    the global top and bottom is the padding real;
  * the nearest resize of the PAFPN maps output row o to input row
    ``floor(o * H_in / H_out)`` of the *global* sizes (torch's own index
    map, read off ``F.interpolate``): those rows are fetched and gathered;
  * the head's stems and predictions are local and its 3x3 convs take a
    halo; then each level's ``5 + C`` maps are gathered once, in row order,
    on the primary device (``mesh.devices[0]``), where the unchanged decode
    and ``postprocess_fixed`` (kernel B1) run on global grids.

It is work division, not approximation: every output element reduces over
its own receptive field, so the sharded step equals the unsharded one up to
the order of float sums (``tests/test_torch_spatial.py``). One process and
one host thread drive every device, as the JAX mesh is single-controller;
no ``torch.distributed`` (``parallel/multihost.py`` is the data-parallel
path). A device may repeat in a mesh (``["cpu"] * 4`` in the tests,
``["cuda:0"] * 2`` on one card): its shards then share one model copy.
"""

from __future__ import annotations

import copy
import functools
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from streamyolo_torch.models.darknet import CSPDarknet
from streamyolo_torch.models.heads import YOLOXHead, eval_outputs
from streamyolo_torch.nn.blocks import (BaseConv, Bottleneck, CSPLayer, DWConv, Focus,
                                        SPPBottleneck, space_to_depth_focus)
from streamyolo_torch.utils.device import resolve_device

SPATIAL_AXIS = "spatial"

Device = Union[str, torch.device]


def _canonical(device: Device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SpatialMesh(NamedTuple):
    """A 1-D mesh (its one axis is ``SPATIAL_AXIS``): the ordered devices
    over which one frame's rows are sliced (device i holds the i-th chunk).
    A device may repeat."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def make_spatial_mesh(devices: Optional[Sequence[Device]] = None) -> SpatialMesh:
    """1-D mesh over which one frame's rows are sliced; by default every
    visible CUDA device (raises without one, as ``resolve_device`` does)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices (e.g. "
                               "['cpu'] * 2) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError("a spatial mesh needs at least one device")
    return SpatialMesh(devices)


def row_ranges(height: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """The canonical partition of ``height`` rows over ``n`` shards: shard i
    holds ``[i c, (i + 1) c)`` clipped to ``height``, ``c = ceil(height /
    n)`` (GSPMD's padded split; trailing shards may be short or empty)."""
    c = -(-height // n)
    return tuple((min(i * c, height), min((i + 1) * c, height)) for i in range(n))


class RowSharding(NamedTuple):
    """H of an NCHW feature map (or NHWC image, ``dim=1``) sliced across the
    mesh in the canonical partition, at any height."""

    mesh: SpatialMesh

    def ranges(self, height: int) -> Tuple[Tuple[int, int], ...]:
        return row_ranges(height, self.mesh.size)

    def shard(self, x: torch.Tensor, dim: int = 2) -> Tuple[torch.Tensor, ...]:
        """Device i's rows of the global ``x`` (on any device), on device i."""
        return tuple(x.narrow(dim, r0, r1 - r0).to(d)
                     for (r0, r1), d in zip(self.ranges(x.shape[dim]), self.mesh.devices))

    def fetch(self, parts: Sequence[torch.Tensor], height: int, r0: int, r1: int,
              device: torch.device, dim: int = 2) -> torch.Tensor:
        """Global rows ``[r0, r1)`` of the map sharded as ``parts``, on
        ``device``: each piece is read from the shard that holds it, however
        far away, and copied over (a view when it is one local piece)."""
        pieces = [p.narrow(dim, max(r0, s0) - s0, min(r1, s1) - max(r0, s0)).to(device)
                  for p, (s0, s1) in zip(parts, self.ranges(height))
                  if max(r0, s0) < min(r1, s1)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 2) -> torch.Tensor:
        """The global map, in row order, on the primary device."""
        primary = self.mesh.devices[0]
        return torch.cat([p.to(primary) for p in parts if p.shape[dim]], dim=dim)


def row_sharding(mesh: SpatialMesh) -> RowSharding:
    """Shard H across ``mesh``."""
    return RowSharding(mesh)


class Replicas:
    """One copy of a model per distinct device of a mesh: ``model`` itself
    (on ``mesh.devices[0]``) and a deep copy on each other device, in the
    same dtype and memory format. ``model.load_state_dict`` loads the new
    state into every copy too (a post hook on ``model``); ``sync()`` does
    it by hand after any other in-place change of the weights."""

    def __init__(self, mesh: SpatialMesh, model: nn.Module):
        self.mesh, self.model = mesh, model
        self.copies: Dict[torch.device, nn.Module] = {mesh.devices[0]: model}
        for dev in mesh.distinct()[1:]:
            rep = copy.deepcopy(model).to(dev).eval()
            if dev.type == "cuda":
                rep = rep.to(memory_format=torch.channels_last)
            self.copies[dev] = rep
        ref = weakref.ref(self)

        def sync_after_load(module, incompatible_keys):
            reps = ref()
            if reps is not None and module is reps.model:
                reps.sync()

        # a plain function: a deep copy of the model shares it, and it acts
        # only on this object's own model
        model.register_load_state_dict_post_hook(sync_after_load)

    def sync(self) -> None:
        state = self.model.state_dict()
        for rep in self.copies.values():
            if rep is not self.model:
                rep.load_state_dict(state, strict=True)

    def per_shard(self) -> List[nn.Module]:
        """The copy each mesh position computes with."""
        return [self.copies[d] for d in self.mesh.devices]

    def __getitem__(self, device: Device) -> nn.Module:
        return self.copies[_canonical(device)]


def replicated(mesh: SpatialMesh, model: nn.Module) -> Replicas:
    """``model`` (on ``mesh.devices[0]``) with one copy per other distinct
    device of ``mesh``, loaded with the same state."""
    return Replicas(mesh, model)


# ----------------------------------------------------------- sharded maps


class Rows(NamedTuple):
    """A feature map sliced along H: ``parts[i]`` (NCHW) holds the global
    rows ``row_ranges(height, n)[i]`` on mesh device i."""

    parts: Tuple[torch.Tensor, ...]
    height: int


def _fill_empty(sh: RowSharding, outs: List[Optional[torch.Tensor]]) -> Tuple[torch.Tensor, ...]:
    """An empty shard's output: zero rows of the others' channels and width."""
    ref = next(o for o in outs if o is not None)
    return tuple(o if o is not None else torch.empty(
        (ref.shape[0], ref.shape[1], 0, ref.shape[3]), dtype=ref.dtype, device=d)
        for o, d in zip(outs, sh.mesh.devices))


def local(sh: RowSharding, fn: Callable, *xs: Rows) -> Rows:
    """``fn(i, *slabs)`` on each non-empty shard: an op that reads no
    neighbouring row. Every operand is in the canonical partition of one
    height."""
    height = xs[0].height
    if any(x.height != height for x in xs):
        raise ValueError(f"local op on maps of heights {[x.height for x in xs]}")
    outs = [fn(i, *(x.parts[i] for x in xs)) if r1 > r0 else None
            for i, (r0, r1) in enumerate(sh.ranges(height))]
    return Rows(_fill_empty(sh, outs), height)


def windowed(sh: RowSharding, fn: Callable, x: Rows, k: int, s: int, p: int) -> Rows:
    """A (k, s, p) window along H: ``fn(i, slab)`` is the unchanged op, which
    pads its slab itself by ``p``. Shard i's output rows ``[o0, o1)`` read
    input rows ``[o0 s - p, (o1 - 1) s - p + k)`` clipped to the map; the
    slab starts on a multiple of ``s`` (its output rows then fall on the
    global grid), and the output rows before ``o0`` and from ``o1`` on,
    whose windows touch the slab's own padding, are cropped."""
    h_out = (x.height + 2 * p - k) // s + 1
    outs = []
    for i, (o0, o1) in enumerate(sh.ranges(h_out)):
        if o1 == o0:
            outs.append(None)
            continue
        a = max(o0 * s - p, 0) // s * s
        b = min((o1 - 1) * s - p + k, x.height)
        y = fn(i, sh.fetch(x.parts, x.height, a, b, sh.mesh.devices[i]))
        j0 = o0 - a // s
        outs.append(y[:, :, j0:j0 + o1 - o0])
    return Rows(_fill_empty(sh, outs), h_out)


@functools.lru_cache(maxsize=64)
def nearest_index(n_in: int, n_out: int) -> Tuple[int, ...]:
    """The source index of each output index of torch's nearest resize
    (``F.interpolate(mode='nearest')``: ``floor(o * (float) n_in / n_out)``),
    read off ``F.interpolate`` itself."""
    src = torch.arange(n_in, dtype=torch.float32).view(1, 1, n_in, 1)
    return tuple(int(v) for v in F.interpolate(src, size=(n_out, 1), mode="nearest").view(-1))


@functools.lru_cache(maxsize=256)
def _index_on(index: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(index, dtype=torch.long, device=device)


def resize_rows(sh: RowSharding, x: Rows, size: Tuple[int, int]) -> Rows:
    """``ops/resize.py::resize_nearest`` of the global map to ``size``: each
    shard fetches the source rows of its output rows (global index map) and
    gathers them, then the columns."""
    h_out, w_out = size
    w_in = x.parts[0].shape[-1]
    if (x.height, w_in) == (h_out, w_out):
        return x
    rows, cols = nearest_index(x.height, h_out), nearest_index(w_in, w_out)
    outs = []
    for i, (o0, o1) in enumerate(sh.ranges(h_out)):
        if o1 == o0:
            outs.append(None)
            continue
        dev = sh.mesh.devices[i]
        a, b = rows[o0], rows[o1 - 1] + 1
        slab = sh.fetch(x.parts, x.height, a, b, dev)
        y = slab.index_select(2, _index_on(tuple(r - a for r in rows[o0:o1]), dev))
        if w_out != w_in:
            y = y.index_select(3, _index_on(cols, dev))
        if dev.type == "cuda":
            y = y.contiguous(memory_format=torch.channels_last)
        outs.append(y)
    return Rows(_fill_empty(sh, outs), h_out)


# ------------------------------------------------ rules, by module type

_RULES: Dict[type, Callable] = {}


def _rule(*types):
    def register(fn):
        for t in types:
            _RULES[t] = fn
        return fn
    return register


def run(sh: RowSharding, mods: Sequence[nn.Module], x: Rows):
    """``mods[i]`` (one module of the same structure per mesh position,
    ``Replicas.per_shard``) applied to the sharded ``x``, by the rule of
    the module's type."""
    for t in type(mods[0]).__mro__:
        if t in _RULES:
            return _RULES[t](sh, mods, x)
    raise TypeError(f"no row-sharded rule for {type(mods[0]).__name__}")


def _sub(mods: Sequence[nn.Module], name: str) -> List[nn.Module]:
    return [getattr(m, name) for m in mods]


@_rule(nn.Sequential)
def _sequential(sh, mods, x):
    for j in range(len(mods[0])):
        x = run(sh, [m[j] for m in mods], x)
    return x


@_rule(BaseConv, nn.Conv2d)
def _conv(sh, mods, x):
    conv = mods[0].conv if isinstance(mods[0], BaseConv) else mods[0]
    (k, kw), (s, sw) = conv.kernel_size, conv.stride
    p = (k - 1) // 2
    if k != kw or s != sw or tuple(conv.padding) != (p, p) or conv.dilation != (1, 1):
        raise TypeError(f"no row-sharded rule for {conv}")
    apply = lambda i, slab: mods[i](slab)  # noqa: E731
    if k == 1 and s == 1:
        return local(sh, apply, x)
    return windowed(sh, apply, x, k, s, p)


@_rule(DWConv)
def _dwconv(sh, mods, x):
    return run(sh, _sub(mods, "pconv"), run(sh, _sub(mods, "dconv"), x))


@_rule(Bottleneck)
def _bottleneck(sh, mods, x):
    y = run(sh, _sub(mods, "conv2"), run(sh, _sub(mods, "conv1"), x))
    return local(sh, lambda i, a, b: a + b, y, x) if mods[0].use_add else y


def _cat(sh: RowSharding, *xs: Rows) -> Rows:
    return local(sh, lambda i, *slabs: torch.cat(slabs, dim=1), *xs)


@_rule(CSPLayer)
def _csp(sh, mods, x):
    x1 = run(sh, _sub(mods, "m"), run(sh, _sub(mods, "conv1"), x))
    x2 = run(sh, _sub(mods, "conv2"), x)
    return run(sh, _sub(mods, "conv3"), _cat(sh, x1, x2))


@_rule(SPPBottleneck)
def _spp(sh, mods, x):
    """conv1, then ONE fetch with the widest pool's halo; every pool (stride
    1, same padding) runs on that slab and is cropped alike."""
    x = run(sh, _sub(mods, "conv1"), x)
    ks = [int(m.kernel_size if isinstance(m.kernel_size, int) else m.kernel_size[0])
          for m in mods[0].m]
    p = max(ks) // 2
    pools = lambda i, slab: torch.cat([slab] + [m(slab) for m in mods[i].m], dim=1)  # noqa: E731
    return run(sh, _sub(mods, "conv2"), windowed(sh, pools, x, 2 * p + 1, 1, p))


@_rule(Focus)
def _focus(sh, mods, x):
    y = windowed(sh, lambda i, slab: space_to_depth_focus(slab), x, k=2, s=2, p=0)
    return run(sh, _sub(mods, "conv"), y)


@_rule(CSPDarknet)
def _cspdarknet(sh, mods, x) -> Dict[str, Rows]:
    outputs = {}
    x = run(sh, _sub(mods, "stem"), x)
    outputs["stem"] = x
    for name in ("dark2", "dark3", "dark4", "dark5"):
        x = run(sh, _sub(mods, name), x)
        outputs[name] = x
    return {k: v for k, v in outputs.items() if k in mods[0].out_features}


# ------------------------------------------------------------ the model


class SpatialStreamYOLO:
    """The ``on_pipe`` step of a ``StreamYOLO`` (``DFPPAFPN`` backbone, a
    ``YOLOXHead``) with one frame's rows sliced over ``mesh``. ``model``
    must be on ``mesh.devices[0]``; ``replicas`` holds its copies.

    ``__call__(parts, buffer=None)``: ``parts`` is the NHWC frame sharded by
    rows (``sharding.shard(image, dim=1)``), ``buffer`` the carried DFP
    buffer, one tuple of slabs per level, each slab on its device (``None``:
    the star frame fuses with itself). Returns the decoded ``[B, N, 5+C]``
    predictions on the primary device and this frame's features in the
    buffer's layout."""

    def __init__(self, model: nn.Module, mesh: SpatialMesh):
        self.mesh, self.sharding = mesh, row_sharding(mesh)
        self.replicas = replicated(mesh, model)
        self.model = model

    def _per_shard(self, path: str) -> List[nn.Module]:
        return [m.get_submodule(path) for m in self.replicas.per_shard()]

    def pafpn(self, x: Rows) -> Tuple[Rows, Rows, Rows]:
        """``DFPPAFPN.pafpn``, sharded."""
        sh, net = self.sharding, self.model.backbone
        feats = run(sh, self._per_shard("backbone.backbone"), x)
        x2, x1, x0 = (feats[f] for f in net.in_features)
        conv = lambda name, v: run(sh, self._per_shard(f"backbone.{name}"), v)  # noqa: E731
        width = lambda v: v.parts[0].shape[-1]  # noqa: E731

        fpn_out0 = conv("lateral_conv0", x0)
        f_out0 = conv("C3_p4", _cat(sh, resize_rows(sh, fpn_out0, (x1.height, width(x1))), x1))
        fpn_out1 = conv("reduce_conv1", f_out0)
        pan_out2 = conv("C3_p3", _cat(sh, resize_rows(sh, fpn_out1, (x2.height, width(x2))), x2))
        pan_out1 = conv("C3_n3", _cat(sh, conv("bu_conv2", pan_out2), fpn_out1))
        pan_out0 = conv("C3_n4", _cat(sh, conv("bu_conv1", pan_out1), fpn_out0))
        return pan_out2, pan_out1, pan_out0

    def dfp_fuse(self, cur: Sequence[Rows], sup: Sequence[Rows]) -> List[Rows]:
        """``cat(jian(cur), jian(sup)) + cur`` per level: local."""
        out = []
        for name, c, s in zip(("jian2", "jian1", "jian0"), cur, sup):
            jian = self._per_shard(f"backbone.{name}")
            out.append(local(self.sharding, lambda i, a, b: torch.cat(
                [jian[i](a), jian[i](b)], dim=1) + a, c, s))
        return out

    def head(self, xin: Sequence[Rows]) -> List[torch.Tensor]:
        """``YOLOXHead.forward``, sharded; each level's maps gathered on the
        primary device."""
        sh, heads = self.sharding, self._per_shard("head")
        if not isinstance(heads[0], YOLOXHead):
            raise TypeError(f"no row-sharded rule for head {type(heads[0]).__name__}")
        outputs = []
        for k, x in enumerate(xin):
            at = lambda name: [getattr(h, name)[k] for h in heads]  # noqa: E731
            x = run(sh, at("stems"), x)
            cls_out = run(sh, at("cls_preds"), run(sh, at("cls_convs"), x))
            reg_feat = run(sh, at("reg_convs"), x)
            out = local(sh, lambda i, r, c: torch.cat(
                [heads[i].reg_preds[k](r), heads[i].obj_preds[k](r), c], dim=1),
                reg_feat, cls_out)
            outputs.append(sh.gather(out.parts))
        return outputs

    def __call__(self, parts: Sequence[torch.Tensor], buffer=None):
        height = sum(p.shape[1] for p in parts)
        dtype = self.model.dtype
        x = Rows(tuple(p.to(dtype).permute(0, 3, 1, 2) for p in parts), height)
        cur = self.pafpn(x)
        sup = cur if buffer is None else [Rows(tuple(b), c.height)
                                          for b, c in zip(buffer, cur)]
        outputs = self.head(self.dfp_fuse(cur, sup))
        return eval_outputs(outputs, self.model.head.strides), tuple(c.parts for c in cur)


__all__ = [
    "SPATIAL_AXIS",
    "Replicas",
    "RowSharding",
    "Rows",
    "SpatialMesh",
    "SpatialStreamYOLO",
    "local",
    "make_spatial_mesh",
    "nearest_index",
    "replicated",
    "resize_rows",
    "row_ranges",
    "row_sharding",
    "run",
    "windowed",
]
