from streamyolo_torch.utils.device import resolve_device
from streamyolo_torch.utils.logger import get_logger

__all__ = ["get_logger", "resolve_device"]
