from streamyolo_torch.exp.base import SHIPPED_CONFIGS, SIZE_CONFIGS, BaseExp, get_exp
from streamyolo_torch.exp.stream_exp import StreamExp

__all__ = ["SHIPPED_CONFIGS", "SIZE_CONFIGS", "BaseExp", "StreamExp", "get_exp"]
