"""The data plane. `RowBlock`, `DeviceBatch` and `MinibatchIter` load
on first use, so the host-only modules of this package (filesys,
match_file), which the scheduler imports, do not pull in torch."""

_LAZY = {"RowBlock": "rowblock", "DeviceBatch": "rowblock",
         "MinibatchIter": "minibatch"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


__all__ = sorted(_LAZY)
