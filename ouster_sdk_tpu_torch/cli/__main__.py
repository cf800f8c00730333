"""`python -m ouster_sdk_tpu_torch.cli` entry point.

Uses the full runner (plugin discovery, invocation log, reference exit
codes — ref: python/src/ouster/cli/core/__init__.py:148-236)."""

from ouster_sdk_tpu_torch.cli import run

if __name__ == "__main__":
    run()
