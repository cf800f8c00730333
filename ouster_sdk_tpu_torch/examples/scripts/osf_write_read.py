"""Record a source to OSF (collated), then read it back indexed.

(ref: sdk/examples/osf.py — runnable doc examples)
Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.osf_write_read \
        <pcap-or-osf> [out.osf]
"""
import sys

from ouster_sdk_tpu_torch import ChanField, open_source
from ouster_sdk_tpu_torch.io.osf import OsfScanSource, Writer


def main():
    src_url = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "recording.osf"

    source = open_source(src_url)
    with Writer(out, encoder="png") as w:
        for info in source.sensor_info:
            w.add_sensor(info)
        n = 0
        for ls_set in source:
            valid = ls_set.valid()
            if valid and all(s.first_valid_packet_timestamp()
                             for s in valid):
                w.save_set(ls_set)  # records the collation grouping too
            else:
                # sources without packet timestamps (e.g. some OSFs)
                # save per-sensor streams only
                for idx, s in enumerate(ls_set):
                    if s is not None:
                        w.save(idx, s)
            n += len(valid)
    print(f"wrote {n} scans to {out}")

    back = OsfScanSource(out)
    print(f"read back: {len(back)} scan sets, collated={back.is_collated()}")
    scan = back[0].valid()[0]
    rng = scan.field(ChanField.RANGE)
    print(f"first scan: frame_id={scan.frame_id} "
          f"valid_px={(rng > 0).sum()}")
    back.close()


if __name__ == "__main__":
    main()
