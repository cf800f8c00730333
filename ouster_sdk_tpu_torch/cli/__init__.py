"""The command line of ouster_sdk_tpu_torch (`python -m
ouster_sdk_tpu_torch`, the ouster-cli equivalent).

The names below resolve on first access, so that the click-free module
cli/util.py (the bodies of `util system-info` and `util benchmark`)
imports where click is not installed. Asking for `cli` or `main` loads
the command set: cli/core.py and the commands cli/extra.py registers."""

_NAMES = {
    "cli": "core",
    "main": "core",
    "SourceArgsException": "runner",
    "find_plugins": "runner",
    "run": "runner",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    mod = importlib.import_module(f"{__name__}.{_NAMES[name]}")
    if _NAMES[name] == "core":
        importlib.import_module(f"{__name__}.extra")  # registers commands
    value = getattr(mod, name)
    globals()[name] = value
    return value
