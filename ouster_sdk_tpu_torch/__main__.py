"""`python -m ouster_sdk_tpu_torch` entry point (ouster-cli equivalent)."""

from ouster_sdk_tpu_torch.cli import cli

if __name__ == "__main__":
    cli()
