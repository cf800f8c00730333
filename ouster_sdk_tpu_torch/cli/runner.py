"""CLI entry-point runner: plugin discovery, logging, exit-code contract.

Rebuild of the reference's top-level CLI runner (ref: python/src/ouster/
cli/core/__init__.py:106-236): plugins are discovered by importing every
module under the ``ouster_sdk_tpu_torch.cli.plugins`` namespace (bad
plugins warn and are skipped, never crash the CLI); ``run()`` wraps the click
group with a rotating debug log of every invocation and maps exception
classes onto the reference's exit codes:

    0  success            2  ClientError
    1  click.Abort        3  SourceArgsException (unexpected extra args)
    e.exit_code  ClickException   4  internal error (with --traceback)
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import platform
import sys
import traceback
from typing import List, Optional

import click

TRACEBACK = False
TRACEBACK_FLAG = "--traceback"

# Invocation log, separate from the SDK logger — mirrors the reference's
# "cli-args-logger" rotating file in ~/.ouster-cli (ref: cli/core/
# __init__.py:23,148-191).
logger = logging.getLogger("cli-args-logger")


class SourceArgsException(Exception):
    """Raised when a chained source pipeline gets unexpected extra args
    (ref: cli/core/__init__.py:49-58)."""

    def __init__(self, context_object):
        self._context_object = context_object
        super().__init__("Incorrect Args Supplied")

    def get_usage(self) -> str:
        return self._context_object.get_usage()

    def get_unexpected_args(self):
        return self._context_object.args


def is_package_related_error(exception: Exception) -> bool:
    """Heuristic for dependency-rooted failures, used to decide whether
    to dump the installed-package list into the debug log (ref:
    cli/core/__init__.py:36-46)."""
    if isinstance(exception, (ImportError, ModuleNotFoundError,
                              AttributeError)):
        return True
    msg = str(exception).lower()
    return any(k in msg for k in (
        "version", "compatibility", "incompatible", "requires",
        "dependency", "not installed", "missing"))


def log_packages() -> None:
    try:
        from importlib.metadata import distributions
        pkgs = sorted(f"{d.metadata['Name']}=={d.version}"
                      for d in distributions())
        logger.debug(str(pkgs))
    except Exception as e:  # pragma: no cover - metadata always present
        logger.debug(f"Failed to log packages: {e}")


def find_plugins(show_traceback: bool = False) -> List:
    """Import every module under ouster_sdk_tpu_torch.cli.plugins,
    returning the module infos that were found. Import errors warn (yellow, to
    stderr) and skip the plugin instead of killing the CLI (ref:
    cli/core/__init__.py:106-145)."""
    import importlib
    import pkgutil

    from . import plugins as plugins_pkg

    submodules = []
    for module in pkgutil.iter_modules(plugins_pkg.__path__,
                                       plugins_pkg.__name__ + "."):
        try:
            if module.ispkg:
                subpkg = importlib.import_module(module.name)
                for sub in pkgutil.iter_modules(subpkg.__path__,
                                                subpkg.__name__ + "."):
                    submodules.append(sub)
                    importlib.import_module(sub.name)
            else:
                submodules.append(module)
                importlib.import_module(module.name)
        except Exception as e:
            logger.debug(
                f"Failed to load plugin {module.name} due to an error.")
            click.echo(click.style(
                f"Failed to load plugin {module.name} due to an error: "
                f"{e}", fg="yellow"), err=True)
            if show_traceback:
                click.echo(click.style(traceback.format_exc(),
                                       fg="yellow"), err=True)
            else:
                click.echo(click.style(
                    f"Run {os.path.basename(sys.argv[0])} "
                    f"{TRACEBACK_FLAG} for debug output.",
                    fg="yellow"), err=True)
            if is_package_related_error(e):
                logger.debug("Plugin load failed due to package-related "
                             "error, listing packages")
                log_packages()
    return submodules


def _log_location() -> str:
    if platform.system() == "Windows":  # pragma: no cover
        base = (os.getenv("LOCALAPPDATA") or os.getenv("TMP") or "C:")
        return os.path.join(base, "ouster-cli", "cli.log")
    return os.path.join(os.path.expanduser("~"), ".ouster-cli",
                        "cli.log")


def _setup_invocation_log() -> None:
    if logger.handlers:
        return  # in-process re-entry (tests, embedders): keep one sink
    location = _log_location()
    log_dir = os.path.dirname(location)
    handler: Optional[logging.Handler] = None
    if not os.path.exists(log_dir):
        try:
            os.makedirs(log_dir)
        except Exception as e:
            click.echo(f"Can't enable logging: {e}")
            handler = logging.NullHandler()
    if handler is None and not os.access(log_dir, os.W_OK):
        click.echo("Can't enable logging")
        handler = logging.NullHandler()
    if handler is None:
        handler = logging.handlers.RotatingFileHandler(
            location, maxBytes=5 * 1024 * 1024, backupCount=10)
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    logger.propagate = False


def run(args=None) -> None:
    """Top-level console entry point (ref: cli/core/__init__.py:148-236):
    discover plugins, run the click group in non-standalone mode, and
    translate exceptions to the reference's exit codes."""
    global TRACEBACK

    from ..sensor import ClientError
    from .core import cli

    _setup_invocation_log()
    logger.debug(platform.python_version() + " : " + " ".join(sys.argv))

    argv = list(sys.argv[1:] if args is None else args)
    exit_code = 0
    try:
        find_plugins(TRACEBACK_FLAG in argv)
        cli.main(args=argv, standalone_mode=False)
    except click.Abort:
        print("Aborted!")
        logger.debug("Aborted!")
        exit_code = 1
    except click.ClickException as e:
        e.show(file=sys.stderr)
        exit_code = e.exit_code
        logger.debug(e)
    except ClientError as e:
        print(f"Client error: {e}", file=sys.stderr)
        logger.debug(e)
        exit_code = 2
    except SourceArgsException as e:
        print(e.get_usage())
        print("")
        print("Error: Got unexpected extra arguments "
              f"({' '.join(e.get_unexpected_args())})")
        exit_code = 3
        logger.debug(e.get_unexpected_args())
    except Exception as e:
        click.secho(f"ERROR: {e}", fg="red")
        if TRACEBACK:
            print("-" * 70)
            traceback.print_exc(file=sys.stderr)
            print("-" * 70)
            print(f"Internal error: {e}", file=sys.stderr)
            exit_code = 4
            logger.debug(e)
        else:
            print(f"Add the {TRACEBACK_FLAG} option after ouster-cli "
                  "for more information.")
        if is_package_related_error(e):
            logger.debug("Unexpected exception with package indicators, "
                         "listing packages")
            log_packages()
        else:
            logger.debug("Unexpected exception (probably not "
                         "package-related)")
            logger.debug(f"Exception type: {type(e).__name__}, "
                         f"message: {e}")
    logger.debug("return code: " + str(exit_code))
    sys.exit(exit_code)
