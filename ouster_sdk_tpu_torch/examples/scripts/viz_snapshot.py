"""Render a scan to a PNG with the offscreen viewer.

(ref: sdk/examples/viz.py — runnable doc examples)
Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.viz_snapshot \
        <pcap-or-osf> [out.png]
"""
import sys

from ouster_sdk_tpu_torch import open_source
from ouster_sdk_tpu_torch.viz.core import ls_show


def main():
    url = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "scan.png"
    source = open_source(url)
    scan = next(iter(source)).valid()[0]
    ls_show(scan, path=out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
