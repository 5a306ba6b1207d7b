"""Architecture registry of the port (counterpart of ``repro.configs``):
the configs the port can run, each as a selectable ``ArchSpec``."""

from .registry import ArchSpec, ShapeSpec, get_arch, list_archs  # noqa: F401
