"""The plain reference of the benchmark, in numpy: XYZ from Ouster's
published range-to-XYZ formula in float64 (lut.py), the scans a sensor's
packets decode to (scan.py), a pcap reader and packet decoder (decode.py)
and the comparisons that decide `correct` (compare.py). It imports nothing
of the program and takes nothing the program made: it reads the
configuration's metadata and makes the synthesized frames again from the
seed."""
