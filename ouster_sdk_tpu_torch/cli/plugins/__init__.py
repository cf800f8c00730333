"""Drop-in CLI plugin namespace.

Rebuild of the reference plugin mechanism (ref: python/src/ouster/cli/
core/__init__.py:106-145 find_plugins over ouster.cli.plugins): every
module (or package of modules) placed in this directory is imported at
CLI startup. Importing a plugin module is how it registers itself — it
typically does::

    from ouster_sdk_tpu_torch.cli import cli

    @cli.command("my-command")
    def my_command():
        ...

A plugin that raises on import is reported as a warning (with the
offending module name) and skipped; the CLI keeps running with the
remaining commands — matching the reference's graceful bad-plugin
handling (ref: cli/core/__init__.py:123-143). Run with ``--traceback``
to see the full import traceback.
"""
