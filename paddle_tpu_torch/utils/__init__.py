from . import unique_name

__all__ = ["unique_name"]
