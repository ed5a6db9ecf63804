"""Deprecated compat shim: the serving engines live in
:mod:`repro_torch.serving` (the reference's ``repro.runtime.serve``).

Importing this module (or any attribute from it) emits a
``DeprecationWarning`` pointing at :mod:`repro_torch.serving`.  Attribute
access forwards to ``repro_torch.serving`` dynamically, so the shim can
never drift from what that package owns.
"""

import warnings

# star-import surface of the old shim (module __getattr__ resolves each)
__all__ = ["Request", "ServeConfig", "ServingEngine", "PagedServingEngine"]

warnings.warn(
    "repro_torch.runtime.serve is deprecated: the serving engines live in "
    "repro_torch.serving (import Request/ServeConfig/ServingEngine/"
    "PagedServingEngine from there)", DeprecationWarning, stacklevel=2)


def __getattr__(name):
    from repro_torch import serving

    if name in serving.__all__:
        warnings.warn(
            f"repro_torch.runtime.serve.{name} is deprecated; import it "
            f"from repro_torch.serving", DeprecationWarning, stacklevel=2)
        return getattr(serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    from repro_torch import serving

    return sorted(set(globals()) | set(serving.__all__))
