"""``repro_torch.index`` — eps-range-query backends (port of
``repro.index``): the backend protocol and registry, the signed-RP
signatures, the sweep engine, the exact backend and the
random-projection backend.

``ExactBackend`` and ``RandomProjectionBackend`` load lazily: their
modules import the kernel packages, which themselves import
``index.signatures`` / ``core.range_query``, so an eager import here
would make ``import repro_torch.kernels...`` order-dependent.
"""

from .base import BACKENDS, RangeBackend, as_fitted, make_backend, register_backend  # noqa: F401
from .signatures import collision_fraction, hamming_band, make_projection, sign_signatures  # noqa: F401


def __getattr__(name):
    if name == "RandomProjectionBackend":
        from .random_projection import RandomProjectionBackend

        return RandomProjectionBackend
    if name == "ExactBackend":
        from .exact import ExactBackend

        return ExactBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
