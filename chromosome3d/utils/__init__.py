from chromosome3d.utils.logging import banner, get_logger

__all__ = ["banner", "get_logger"]
