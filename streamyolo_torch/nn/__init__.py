from streamyolo_torch.nn.blocks import (
    BaseConv,
    Bottleneck,
    CSPLayer,
    DWConv,
    Focus,
    ResLayer,
    SPPBottleneck,
    space_to_depth_focus,
)

__all__ = ["BaseConv", "Bottleneck", "CSPLayer", "DWConv", "Focus", "ResLayer",
           "SPPBottleneck", "space_to_depth_focus"]
