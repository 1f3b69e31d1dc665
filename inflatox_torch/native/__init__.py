from .backend import NativeModel, native_available

__all__ = ["NativeModel", "native_available"]
