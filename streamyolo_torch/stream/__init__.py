from streamyolo_torch.stream.online import CUDAStreamDetector

__all__ = ["CUDAStreamDetector"]
